"""Logical-axis sharding over ``torch.distributed`` (the JAX package's
``shardlib.py``, MaxText-style axis rules).

Model code never names mesh axes directly.  It names *logical* axes
(``"batch"``, ``"rows"``, ``"kv_seq"``) and the active :class:`AxisRules`
context maps them to the named dims of a
``torch.distributed.device_mesh.DeviceMesh``.  Outside any context every
helper is a no-op, so the same model code runs on one device in tests
and across ranks under a mesh.

The SPMD form of the port: one process per rank, and each rank holds its
own **local block** of every sharded tensor.  :func:`maybe_shard_map`
runs a per-shard body on the blocks it is given (JAX's ``shard_map``
cuts a global array instead); the collective helpers (:func:`psum`,
:func:`pmax`, :func:`pmin`, :func:`psum_scatter`, :func:`all_gather`)
reduce over the process group of the named mesh dims, and return their
input when no axis is live, as in JAX.  :func:`local_block` cuts a
rank's block from a global tensor and :func:`gather_blocks` joins the
blocks back.  A mesh lives on ``"cuda"`` over NCCL or on ``"cpu"`` over
gloo (:func:`make_mesh`); nothing falls back from one to the other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = [
    "PartitionSpec", "P", "NamedSharding", "AxisRules", "axis_rules",
    "current_rules", "current_mesh", "logical_to_spec", "shard",
    "sharding_for", "make_mesh", "maybe_shard_map", "psum", "pmax", "pmin",
    "psum_scatter", "all_gather", "axis_size", "axis_index", "local_block",
    "gather_blocks", "GROUP_TIMEOUT",
]

#: Timeout of every group :func:`make_mesh` creates: a rank that raises
#: leaves the others in a collective, which then fails instead of
#: hanging.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh dim name, a tuple of them, or
    ``None`` (replicated); trailing ``None`` dims may be left out.  A
    tuple, so specs compare as tuples (``tuple(jax P(...))`` in tests)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):           # pickle rebuilds from the parts
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: where a tensor's local blocks come from."""
    mesh: Any
    spec: PartitionSpec


class AxisRules:
    """Mapping from logical axis names to mesh axis names (or tuples)."""

    def __init__(self, mesh, rules: Dict[str, Union[str, Tuple[str, ...],
                                                    None]]):
        self.mesh = mesh
        self.rules = dict(rules)

    def resolve(self, name: Optional[str]):
        if name is None:
            return None
        return self.rules.get(name, None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, Any]):
    """Make ``rules`` over ``mesh`` current in this thread."""
    prev = getattr(_state, "rules", None)
    _state.rules = AxisRules(mesh, rules)
    try:
        yield _state.rules
    finally:
        _state.rules = prev


def current_rules() -> Optional[AxisRules]:
    return getattr(_state, "rules", None)


def current_mesh():
    r = current_rules()
    return r.mesh if r is not None else None


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def logical_to_spec(*names: Optional[str]) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec under the current
    rules: a mesh dim already used by an earlier name is dropped, a
    tuple-valued rule stays a tuple, trailing ``None``s are trimmed."""
    r = current_rules()
    if r is None:
        return P()
    used: set = set()
    parts = []
    for nm in names:
        ax = r.resolve(nm)
        if ax is None:
            parts.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a not in used
                     and a in _names(r.mesh))
        used.update(ax_t)
        if not ax_t:
            parts.append(None)
        elif isinstance(ax, str):
            parts.append(ax_t[0])
        else:
            parts.append(ax_t)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def sharding_for(*names: Optional[str]) -> Optional[NamedSharding]:
    r = current_rules()
    if r is None:
        return None
    return NamedSharding(r.mesh, logical_to_spec(*names))


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """GSPMD's layout constraint has no eager counterpart: a rank holds
    its local block already, laid out by the cell's ``in_shardings``
    (:func:`local_block`), and nothing re-partitions it between
    operations.  So this is ``x``, with or without a mesh."""
    return x


# ---------------------------------------------------------------------------
# Meshes and their groups
# ---------------------------------------------------------------------------

def _groups_along(ranks: torch.Tensor, dims: Tuple[int, ...]):
    """Rank lists of the groups over mesh dims ``dims`` (row-major in
    the order given), one per coordinate of the other dims."""
    rest = [d for d in range(ranks.dim()) if d not in dims]
    moved = ranks.permute(*rest, *dims)
    size = 1
    for d in dims:
        size *= ranks.shape[d]
    return [row.tolist() for row in moved.reshape(-1, size)]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str, ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` over ``ranks`` (default: every rank
    of the default group, row-major), with named dims, on ``"cuda"``
    (NCCL) or ``"cpu"`` (gloo).  Every rank of the default group must
    call it; a rank outside ``ranks`` gets ``None``.  The groups of each
    dim, and of each set of two or more dims (row-major, for a
    tuple-valued rule such as ``("data", "model")``), are made here
    with :data:`GROUP_TIMEOUT`."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} for axes {names}")
    n = 1
    for s in shape:
        n *= s
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if len(ranks) != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, got {len(ranks)}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    mine = {}
    for k in range(1, len(shape) + 1):
        for dims in itertools.combinations(range(len(shape)), k):
            g, _ = dist.new_subgroups_by_enumeration(
                _groups_along(grid, dims), timeout=GROUP_TIMEOUT)
            mine[tuple(names[d] for d in dims)] = g
    if dist.get_rank() not in ranks:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh.from_group([mine[(a,)] for a in names], device_type,
                                 mesh=grid, mesh_dim_names=names)
    # the groups of several dims, for the collectives over a tuple rule
    mesh._repro_groups = {k: g for k, g in mine.items() if len(k) > 1}
    return mesh


def _axes_tuple(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _live_axes(logical: str) -> Tuple[str, ...]:
    """Mesh axes backing ``logical`` under the current rules (may be
    ())."""
    r = current_rules()
    if r is None:
        return ()
    return tuple(a for a in _axes_tuple(r.resolve(logical))
                 if a in _names(r.mesh))


def _mesh_or_raise():
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a collective over named axes needs an active "
                           "mesh (shardlib.axis_rules)")
    return mesh


def _group(axes: Tuple[str, ...]):
    """The process group over mesh dims ``axes`` (in mesh order)."""
    mesh = _mesh_or_raise()
    names = _names(mesh)
    axes = tuple(sorted(axes, key=names.index))
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = getattr(mesh, "_repro_groups", {})
    if axes not in groups:
        raise ValueError(f"no group over {axes}: build the mesh with "
                         "shardlib.make_mesh")
    return groups[axes]


def psum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (a new tensor; ``x`` without
    axes)."""
    return _reduce(x, tuple(axes), dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    return _reduce(x, tuple(axes), dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Cross-shard min: the (min, +) semiring's reduction."""
    return _reduce(x, tuple(axes), dist.ReduceOp.MIN)


def _reduce(x: torch.Tensor, axes: Tuple[str, ...], op) -> torch.Tensor:
    if not axes:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=_group(axes))
    return y


def psum_scatter(x: torch.Tensor, axes: Sequence[str],
                 scatter_dimension: int = 0) -> torch.Tensor:
    """:func:`psum`, then this rank's tile along ``scatter_dimension``
    (tiled, as JAX's ``psum_scatter(..., tiled=True)``)."""
    axes = tuple(axes)
    if not axes:
        return x
    n = axis_size(axes)
    if x.shape[scatter_dimension] % n:
        raise ValueError(f"dim {scatter_dimension} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    return psum(x, axes).chunk(n, scatter_dimension)[axis_index(axes)] \
        .contiguous()


def _gather_order(group, axes: Tuple[str, ...]) -> Optional[torch.Tensor]:
    """The blocks' order that puts a gather over ``group`` (group rank
    order) in :func:`axis_index` order over ``axes``; ``None`` where the
    two agree, as they do for :func:`make_mesh`'s groups over dims in
    mesh order.  Worked out once a mesh and axes."""
    mesh = _mesh_or_raise()
    cache = getattr(mesh, "_repro_gather_order", None)
    if cache is None:
        cache = mesh._repro_gather_order = {}
    if axes not in cache:
        idx = [_axis_index_of(r, axes, mesh)
               for r in dist.get_process_group_ranks(group)]
        order = sorted(range(len(idx)), key=idx.__getitem__)
        cache[axes] = (None if order == list(range(len(idx)))
                       else torch.tensor(order))
    return cache[axes]


_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, axes: Sequence[str],
               axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axes``, concatenated along ``axis`` in
    :func:`axis_index` order (tiled): one gather into one tensor."""
    axes = tuple(axes)
    if not axes:
        return x
    group = _group(axes)
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_into(out, x, group=group)
    out = out.view((n,) + tuple(x.shape))
    order = _gather_order(group, axes)
    if order is not None:
        out = out.index_select(0, order.to(out.device))
    return out.movedim(0, axis).flatten(axis, axis + 1)


def axis_size(axes: Sequence[str], mesh=None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    out = 1
    names = _names(mesh)
    for a in _axes_tuple(tuple(axes)):
        if a in names:
            out *= mesh.size(names.index(a))
    return out


def _row_major(coord, axes: Tuple[str, ...], mesh) -> int:
    names = _names(mesh)
    idx = 0
    for a in axes:
        d = names.index(a)
        idx = idx * mesh.size(d) + coord[d]
    return idx


def _axis_index_of(rank: int, axes: Tuple[str, ...], mesh=None) -> int:
    """Row-major index of global ``rank`` over mesh dims ``axes``."""
    mesh = mesh or _mesh_or_raise()
    return _row_major((mesh.mesh == rank).nonzero()[0].tolist(), axes, mesh)


def axis_index(axes: Sequence[str], mesh=None) -> int:
    """This rank's index over ``axes``, row-major in the order given
    (0 without axes), as JAX computes it."""
    axes = tuple(axes)
    if not axes:
        return 0
    mesh = mesh or _mesh_or_raise()
    return _row_major(mesh.get_coordinate(), axes, mesh)


# ---------------------------------------------------------------------------
# Local blocks
# ---------------------------------------------------------------------------

def _check_spec(x, spec, mesh, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        return
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"{what}: spec {spec} has more entries than the "
                         f"{x.dim()} dims of its tensor")
    for part in spec:
        for a in _axes_tuple(part):
            if a not in _names(mesh):
                raise ValueError(f"{what}: spec {spec} names {a!r}, not a "
                                 f"dim of the mesh {_names(mesh)}")


def maybe_shard_map(fn: Callable, in_specs, out_specs) -> Callable:
    """The per-shard body ``fn`` on local blocks under an active mesh;
    ``fn`` itself otherwise (world size 1, every collective helper the
    identity).  Under a mesh each argument and result is checked against
    its spec (a spec entry a dim, each named axis a dim of the mesh);
    the blocks themselves are the caller's (:func:`local_block`), as
    every rank holds only its own."""
    mesh = current_mesh()
    if mesh is None:
        return fn

    def mapped(*args):
        for i, (a, s) in enumerate(zip(args, in_specs)):
            _check_spec(a, s, mesh, f"argument {i}")
        out = fn(*args)
        outs, specs = ((out, out_specs) if isinstance(out, tuple)
                       else ((out,), (out_specs,)))
        for i, (o, s) in enumerate(zip(outs, specs)):
            _check_spec(o, s, mesh, f"result {i}")
        return out

    return mapped


def local_block(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``
    (each sharded dim cut evenly, in :func:`axis_index` order);
    contiguous, and ``x`` itself where nothing is cut."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return x
    for d, part in enumerate(tuple(spec)):
        axes = _axes_tuple(part)
        if not axes:
            continue
        n = axis_size(axes, mesh)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {n} ranks of {axes}")
        size = x.shape[d] // n
        x = x.narrow(d, axis_index(axes, mesh) * size, size)
    return x.contiguous()


def gather_blocks(x: torch.Tensor, spec) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` under ``spec``
    (the inverse of :func:`local_block`)."""
    for d, part in enumerate(tuple(spec)):
        x = all_gather(x, _axes_tuple(part), axis=d)
    return x
