"""Plain PyTorch versions of the fused bag-sum."""
import torch


def take_fill(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0, fill_value=0)``: negative ids wrap
    once (``id + V``), and ids still outside ``[0, V)`` give a zero row.
    Returns ``ids.shape + (D,)``."""
    v = table.shape[0]
    idx = torch.where(ids < 0, ids + v, ids).long()
    ok = (idx >= 0) & (idx < v)
    rows = table[torch.where(ok, idx, torch.zeros_like(idx))]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows))


def bag_sum_ref(gathered: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """out[b, d] = sum_k gathered[b, k, d] * mask[b, k].

    Each product is taken in the table's dtype (the mask cast to it, as
    the JAX kernel does), and the products are summed in order of k in
    f32, then cast back: the CUDA kernel's order, so f32 results agree
    bit for bit.
    """
    m = mask.to(gathered.dtype)
    acc = torch.zeros(gathered.shape[0], gathered.shape[2],
                      dtype=torch.float32, device=gathered.device)
    for k in range(gathered.shape[1]):
        acc = acc + (gathered[:, k] * m[:, k, None]).float()
    return acc.to(gathered.dtype)
