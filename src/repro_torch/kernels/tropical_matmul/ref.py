"""Plain PyTorch version of the tropical (min-plus) matrix product.

``out[i, j] = min_k a[i, k] + b[k, j]`` — the core-search primitive: one
application of the precomputed core closure advances every source's
distance vector across the core graph (paper §5.2, closure variant).
"""
import torch


def minplus_ref(a: torch.Tensor, b: torch.Tensor,
                block_k: int = 256) -> torch.Tensor:
    """Min-plus product accumulated over K blocks, so the broadcast
    intermediate is ``[M, block_k, N]`` rather than ``[M, K, N]``.  Min
    is exact in any order, so the blocking changes no bit."""
    m, k = a.shape
    out = torch.full((m, b.shape[1]), float("inf"), dtype=a.dtype,
                     device=a.device)
    for k0 in range(0, k, block_k):
        blk = (a[:, k0:k0 + block_k, None]
               + b[None, k0:k0 + block_k, :]).amin(dim=1)
        torch.minimum(out, blk, out=out)
    return out
