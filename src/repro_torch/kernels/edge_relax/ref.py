"""Plain PyTorch versions of the bucketed edge relaxation."""
from typing import Optional

import torch


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


def relax_level_ref_(dist: torch.Tensor, dst: torch.Tensor,
                     src_idx: torch.Tensor, w: torch.Tensor,
                     row_valid: torch.Tensor) -> torch.Tensor:
    """One plan level, in place on ``dist`` ([S, N]): gather
    ``dist[:, src_idx]``, relax with :func:`relax_bucketed_ref`, then
    scatter-min the rows into ``dist[:, dst]`` (split rows of one
    destination merge there).  Returns ``dist``."""
    s = dist.shape[0]
    src = src_idx.reshape(-1).long()
    gathered = dist.index_select(1, src).reshape(s, *src_idx.shape)
    dst = dst.long()
    cur = dist.index_select(1, dst)
    new = relax_bucketed_ref(gathered, w, cur, row_valid)
    return dist.scatter_reduce_(1, dst.expand(s, -1), new, "amin",
                                include_self=True)
