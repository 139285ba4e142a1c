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


def backward_plan(ids: torch.Tensor, n_rows: int):
    """The backward's index preparation: every slot's row by
    :func:`take_fill`'s rule (a negative id wraps once; a row outside
    ``[0, n_rows)`` after that is ``n_rows``, which gathers nothing),
    and a stable sort of the slots by row.  Returns (rows [N] int32
    ascending, slots [N] int64: the flat slot ``b * K + k`` of each),
    with N = B * K; the slots past the valid ones carry row
    ``n_rows``."""
    flat = ids.reshape(-1).long()
    idx = torch.where(flat < 0, flat + n_rows, flat)
    ok = (idx >= 0) & (idx < n_rows)
    key = torch.where(ok, idx, torch.full_like(idx, n_rows)).to(torch.int32)
    rows, slots = torch.sort(key, stable=True)
    return rows, slots


def bag_sum_backward_ref(grad_out: torch.Tensor, ids: torch.Tensor,
                         mask: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The table's gradient of :func:`bag_sum_ref` ``(take_fill(table,
    ids), mask)``: grad_out [B, D], ids and mask [B, K] ->

        d_table[r, :] = sum over slots (b, k) naming row r of
                        mask[b, k] * grad_out[b, :]

    dense [n_rows, D] in grad_out's dtype, with ids as the forward reads
    them (a negative id wraps once; an id outside ``[0, n_rows)`` after
    that adds nothing).  Each product is one f32 multiply, and each
    row's products are added in slot order (``b * K + k``) onto +0: the
    CUDA kernel's order inside a chunk of slots."""
    b, k = ids.shape
    d = grad_out.shape[1]
    rows, slots = backward_plan(ids, n_rows)
    valid = rows < n_rows
    rows, slots = rows[valid].long(), slots[valid]
    m = mask.reshape(-1).to(grad_out.dtype)[slots]
    contrib = grad_out[slots // k] * m[:, None]            # [N, D]
    out = torch.zeros((n_rows, d), dtype=grad_out.dtype,
                      device=grad_out.device)
    if rows.numel() == 0:
        return out
    # rank of each slot inside its row's run; adding the runs' j-th slots
    # for j = 0, 1, ... sums every row in slot order
    start = torch.ones_like(rows, dtype=torch.bool)
    start[1:] = rows[1:] != rows[:-1]
    pos = torch.arange(rows.numel(), device=rows.device)
    run_start = torch.cummax(torch.where(start, pos, 0), dim=0).values
    rank = pos - run_start
    by_rank = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank).tolist()
    lo = 0
    for n in counts:
        sel = by_rank[lo:lo + n]
        out[rows[sel]] += contrib[sel]        # the rows of one rank differ
        lo += n
    return out
