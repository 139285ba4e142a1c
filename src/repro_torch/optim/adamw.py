"""AdamW with decoupled weight decay, global-norm clipping and f32 state
(the JAX package's ``optim/adamw.py``), over the port's nested dict/list
parameter trees.

The semantics are the JAX module's: the gradients are clipped to a
global norm first; the bias corrections use ``count + 1``; weight decay
is masked off parameters with ``ndim < 2`` (norm scales, biases); the
update is ``p - lr * (step + wd * p)`` in f32 with ``step = (m / bc1) /
(sqrt(v / bc2) + eps)``; m and v are f32.

Unlike the JAX function, which returns new arrays (its train cells
donate the state), :func:`adamw_update` updates the parameters, m and v
**in place** and returns them.  dlrm-rm2's table is 6.66 GB, and each
eager out-of-place operation on it would allocate a table-sized
temporary.  So every pass runs over slices of at most ``_CHUNK``
elements of a leaf, and no temporary is larger than one slice.  Inside a
slice, the operations, their order and their roundings are the JAX
formula's.

Over a mesh the trees hold each rank's blocks: the update is
elementwise, and the global norm (given the leaves' ``NamedSharding``s)
sums each leaf's squares over the ranks that split it, so clipping
sees the whole model's norm.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from .. import shardlib as sl
from ..tree import leaves, map_tree

#: Elements of one slice of a leaf in the in-place passes (256 MB of f32).
_CHUNK = 1 << 26


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor       # int32, 0-d, on the parameters' device


def adamw_init(params) -> OptState:
    """Zero f32 m and v shaped like ``params``, and a zero int32 count
    on the first leaf's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    first = leaves(params)[0]
    return OptState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


def _slices(t: torch.Tensor):
    """Views of at most ``_CHUNK`` elements covering a contiguous
    tensor, in order."""
    flat = t.view(-1)
    for lo in range(0, flat.numel(), _CHUNK):
        yield flat[lo:lo + _CHUNK]


def global_norm(grads, shardings=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(square(g)), in f32, as a 0-d
    tensor on the leaves' device (sliced, so no leaf-sized square).
    ``shardings``: a tree of ``NamedSharding``s, one a leaf, when the
    leaves are this rank's blocks: the squares of the leaves split over
    the same axes are summed in leaf order, then over those ranks (a
    replicated leaf counted once); without a split axis, the order of
    the unsharded sum."""
    specs = (leaves(shardings) if shardings is not None
             else [None] * len(leaves(grads)))
    totals = {}
    for g, s in zip(leaves(grads), specs):
        axes = sl.spec_axes(s.spec) if s is not None else ()
        for sc in _slices(g):
            part = torch.sum(torch.square(sc.float()))
            totals[axes] = (part if axes not in totals
                            else totals[axes] + part)
    total = None
    for axes, part in totals.items():
        part = sl.psum(part, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, shardings=None):
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``;
    returns (grads, norm).  ``shardings``: as :func:`global_norm`."""
    gn = global_norm(grads, shardings)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves(grads):
        for s in _slices(g):
            s.mul_(scale.to(g.dtype))
    return grads, gn


@torch.no_grad()
def adamw_update(params, grads, state: OptState,
                 lr: Union[float, torch.Tensor],
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 shardings=None):
    """One AdamW step, in place.  ``lr`` may be a float or a 0-d tensor
    (a schedule's value).  ``grads`` are clipped in place too, and weight
    decay reaches the leaves with ``ndim >= 2``.  ``shardings``: the
    parameters' ``NamedSharding``s when the trees hold this rank's
    blocks (:func:`global_norm`).  Returns (params, OptState(m, v, count
    + 1), the gradients' global norm)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm, shardings)
    count = state.count + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=cf.device), cf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        decay = weight_decay if p.dim() >= 2 else 0.0
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            gs = gs.float()
            ms.mul_(b1).add_(gs * (1.0 - b1))
            vs.mul_(b2).add_(torch.square(gs).mul_(1.0 - b2))
            step = (ms / bc1).div_(torch.sqrt(vs / bc2).add_(eps))
            pf = ps.float()
            if decay:
                # with decay 0 the term adds +-0 to the step: the same
                # bits for every finite parameter, so it is skipped
                step.add_(pf * decay)
            if ps.dtype == torch.float32:
                ps.sub_(step.mul_(lr))
            else:
                ps.copy_(pf - step.mul_(lr))
    return params, OptState(state.m, state.v, count), gnorm
