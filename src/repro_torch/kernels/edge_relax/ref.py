"""Plain PyTorch versions of the edge relaxation: the JAX kernel's
bucketed contract, and a packed sweep (what ``relax_sweep_`` runs)."""
from typing import Optional

import torch

from .sweep import Sweep


def relax_bucketed_ref(gathered: torch.Tensor, w: torch.Tensor,
                       cur: torch.Tensor,
                       row_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """out[s, m] = min(cur[s, m], min_k gathered[s, m, k] + w[m, k]).

    The JAX package's kernel contract (``gathered`` is
    ``dist[:, src_idx]``, hoisted out of the kernel); ``row_valid``
    ([M] bool) keeps ``cur`` untouched on padding rows.
    """
    new = torch.minimum(cur, (gathered + w[None]).amin(dim=-1))
    if row_valid is None:
        return new
    return torch.where(row_valid[None, :], new, cur)


def relax_sweep_ref_(dist: torch.Tensor, sweep: Sweep) -> torch.Tensor:
    """A packed sweep, level by level, in place on the node-major
    ``dist`` ([N, S]): gather ``dist[src]``, add ``w``, and segment-min
    the slots into their rows' destinations (``scatter_reduce_`` with
    ``include_self``).  Returns ``dist``."""
    s = dist.shape[1]
    for i in range(sweep.n_levels):
        r0, r1 = sweep.level_rows[i:i + 2]
        e0, e1 = sweep.level_slots[i:i + 2]
        if e0 == e1:
            continue
        counts = (sweep.row_ptr[r0 + 1:r1 + 1] - sweep.row_ptr[r0:r1]).long()
        dst = sweep.row_dst[r0:r1].long().repeat_interleave(counts)
        cand = dist.index_select(0, sweep.src[e0:e1].long()) \
            + sweep.w[e0:e1, None]
        dist.scatter_reduce_(0, dst[:, None].expand(-1, s), cand, "amin",
                             include_self=True)
    return dist
