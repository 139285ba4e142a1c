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
rank's block from a global tensor (:func:`block_slices` names where it
lies) and :func:`gather_blocks` joins the blocks back.  A mesh lives on
``"cuda"`` over NCCL or on ``"cpu"`` over gloo (:func:`make_mesh`);
nothing falls back from one to the other.

Gradients cross the collectives (Megatron's convention: a tensor held
whole on every rank of a group carries the whole cotangent on each).
:func:`all_gather` and :func:`psum_scatter` are each other's backward;
:func:`psum` passes its cotangent through unchanged (the sum is held
whole, and each rank's part gets the whole cotangent); :func:`enter`
is the identity forward and a :func:`psum` backward, for a tensor held
whole that meets a product sharded over the group.  :func:`pmax` and
:func:`pmin` carry no gradient.  :func:`reduce_grads` sums the blocks
of a gradient tree over the axes on which each leaf's uses are partial,
and :func:`spec_axes` names the mesh axes a leaf is sharded over.
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

from .tree import leaves

__all__ = [
    "PartitionSpec", "P", "NamedSharding", "AxisRules", "axis_rules",
    "current_rules", "under_current_rules", "current_mesh",
    "logical_to_spec", "shard",
    "sharding_for", "make_mesh", "maybe_shard_map", "psum", "pmax", "pmin",
    "psum_scatter", "all_gather", "enter", "axis_size", "axis_index",
    "block_slices", "local_block", "gather_blocks", "mesh_group",
    "mesh_index", "reduce_grads", "spec_axes",
    "GROUP_TIMEOUT",
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


def under_current_rules(fn: Callable) -> Callable:
    """``fn``, run under the rules current now wherever it is called
    (``fn`` itself without rules).  A checkpointed function's recompute
    runs inside the backward pass, on the card in autograd's device
    thread, which sees no rules of its own."""
    r = current_rules()
    if r is None:
        return fn

    def ruled(*args, **kwargs):
        prev = getattr(_state, "rules", None)
        _state.rules = r
        try:
            return fn(*args, **kwargs)
        finally:
            _state.rules = prev
    return ruled


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
    operations.  So this is ``x``, with or without a mesh.  The model
    code places the collectives itself where GSPMD would (the LM's
    ``models/transformer.py``): the heads' layout over ranks comes from
    ``wq``'s column block, so the annotations inside the attention
    functions (``attention_causal_opt``'s among them) become nothing."""
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
    mesh._repro_ranks = ranks       # row-major, read on the host
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


def _group(axes: Tuple[str, ...], mesh=None):
    """The process group over mesh dims ``axes`` (in mesh order)."""
    mesh = mesh or _mesh_or_raise()
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
    axes).  Its backward passes the cotangent through: the sum is held
    whole on every rank, so each rank's part gets the whole cotangent
    (Megatron's row-parallel reduction)."""
    axes = tuple(axes)
    if not axes:
        return x
    return _Psum.apply(x, axes)


def pmax(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Cross-shard max (no gradient; ``x`` without axes)."""
    axes = tuple(axes)
    return _reduce(x.detach(), axes, dist.ReduceOp.MAX) if axes else x


def pmin(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Cross-shard min: the (min, +) semiring's reduction (no gradient;
    ``x`` without axes)."""
    axes = tuple(axes)
    return _reduce(x.detach(), axes, dist.ReduceOp.MIN) if axes else x


def enter(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x``, held whole on every rank of ``axes``, entering work that
    is sharded over them (a column-parallel product): the identity
    forward, a :func:`psum` of the ranks' partial cotangents backward
    (Megatron's "f").  ``x`` itself without axes."""
    axes = tuple(axes)
    if not axes:
        return x
    return _Enter.apply(x, axes)


def _reduce(x: torch.Tensor, axes: Tuple[str, ...], op,
            mesh=None) -> torch.Tensor:
    if not axes:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=_group(axes, mesh))
    return y


def _psum_scatter(x: torch.Tensor, axes: Tuple[str, ...], dim: int,
                  mesh=None) -> torch.Tensor:
    mesh = mesh or _mesh_or_raise()
    n = axis_size(axes, mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    return _reduce(x, axes, dist.ReduceOp.SUM, mesh).chunk(n, dim)[
        axis_index(axes, mesh)].contiguous()


# The backward of each collective runs where autograd runs it (on the
# card, its device thread, which sees no axis rules): each keeps the
# mesh of its forward.

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return _reduce(x, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.mesh = axes, _mesh_or_raise()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axes, dist.ReduceOp.SUM, ctx.mesh), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, axis):
        ctx.axes, ctx.axis, ctx.mesh = axes, axis, _mesh_or_raise()
        return _all_gather(x, axes, axis, ctx.mesh)

    @staticmethod
    def backward(ctx, g):
        return (_psum_scatter(g, ctx.axes, ctx.axis, ctx.mesh), None,
                None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, _mesh_or_raise()
        return _psum_scatter(x, axes, dim, ctx.mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axes, ctx.dim, ctx.mesh), None, None


def psum_scatter(x: torch.Tensor, axes: Sequence[str],
                 scatter_dimension: int = 0) -> torch.Tensor:
    """:func:`psum`, then this rank's tile along ``scatter_dimension``
    (tiled, as JAX's ``psum_scatter(..., tiled=True)``).  Its backward
    is :func:`all_gather` of the tiles' cotangents."""
    axes = tuple(axes)
    if not axes:
        return x
    return _PsumScatter.apply(x, axes, scatter_dimension)


def _gather_order(group, axes: Tuple[str, ...],
                  mesh=None) -> Optional[torch.Tensor]:
    """The blocks' order that puts a gather over ``group`` (group rank
    order) in :func:`axis_index` order over ``axes``; ``None`` where the
    two agree, as they do for :func:`make_mesh`'s groups over dims in
    mesh order.  Worked out once a mesh and axes."""
    mesh = mesh or _mesh_or_raise()
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
    :func:`axis_index` order (tiled): one gather into one tensor.  Its
    backward is :func:`psum_scatter` of the cotangent: the gathered
    tensor feeds work sharded over ``axes`` (an FSDP weight, a
    sequence-parallel activation), so each rank's cotangent is a part
    of the whole."""
    axes = tuple(axes)
    if not axes:
        return x
    return _AllGather.apply(x, axes, axis)


def _all_gather(x: torch.Tensor, axes: Tuple[str, ...], axis: int,
                mesh=None) -> torch.Tensor:
    mesh = mesh or _mesh_or_raise()
    group = _group(axes, mesh)
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather_into(out, x, group=group)
    out = out.view((n,) + tuple(x.shape))
    order = _gather_order(group, axes, mesh)
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
    """Row-major index of global ``rank`` over mesh dims ``axes`` (the
    rank's coordinate found on the host: no tensor op, so it holds under
    a ``FakeTensorMode`` too)."""
    mesh = mesh or _mesh_or_raise()
    flat = getattr(mesh, "_repro_ranks", None) or mesh.mesh.flatten().tolist()
    coord, i = [], flat.index(rank)
    for n in reversed(mesh.mesh.shape):
        i, c = divmod(i, n)
        coord.append(c)
    return _row_major(coord[::-1], axes, mesh)


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


def block_slices(shape: Sequence[int], spec, mesh=None
                 ) -> Tuple[slice, ...]:
    """The slices, one a dim, that cut this rank's block out of a global
    tensor of ``shape`` under ``spec`` (each sharded dim cut evenly, in
    :func:`axis_index` order); whole dims without a mesh."""
    mesh = mesh or current_mesh()
    out = [slice(0, n) for n in shape]
    if mesh is None:
        return tuple(out)
    for d, part in enumerate(tuple(spec)):
        axes = _axes_tuple(part)
        if not axes:
            continue
        n = axis_size(axes, mesh)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {n} ranks of {axes}")
        size = shape[d] // n
        lo = axis_index(axes, mesh) * size
        out[d] = slice(lo, lo + size)
    return tuple(out)


def local_block(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``
    (:func:`block_slices`): a contiguous tensor of its own where ``x`` is
    cut (never a view that would keep the whole alive), and ``x`` itself
    (made contiguous) where nothing is cut."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return x
    cut = False
    for d, s in enumerate(block_slices(x.shape, spec, mesh)):
        if s.stop - s.start != x.shape[d]:
            x = x.narrow(d, s.start, s.stop - s.start)
            cut = True
    if cut:
        return x.clone(memory_format=torch.contiguous_format)
    return x.contiguous()


def mesh_group(mesh):
    """The process group over every dim of ``mesh`` (one rank a mesh
    position), as :func:`make_mesh` made it."""
    return _group(_names(mesh), mesh)


def mesh_index(mesh) -> int:
    """This rank's row-major position in ``mesh`` (0 to its size - 1)."""
    return axis_index(_names(mesh), mesh)


def gather_blocks(x: torch.Tensor, spec) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` under ``spec``
    (the inverse of :func:`local_block`)."""
    for d, part in enumerate(tuple(spec)):
        x = all_gather(x, _axes_tuple(part), axis=d)
    return x


def spec_axes(spec, mesh=None) -> Tuple[str, ...]:
    """The mesh axes of ``spec`` that split a tensor over more than one
    rank, in mesh order (() without a mesh)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    named = {a for part in tuple(spec) for a in _axes_tuple(part)}
    return tuple(a for a in _names(mesh)
                 if a in named and axis_size((a,), mesh) > 1)


#: Leaves of fewer elements are summed together in one buffer.
_COALESCE = 1 << 22


@torch.no_grad()
def reduce_grads(grads, specs, partial: Sequence[str]) -> None:
    """Sum, in place and over ranks, the gradient blocks of the tree
    ``grads`` whose uses are partial: leaf by leaf over the mesh axes of
    ``partial`` (of more than one rank) that its ``NamedSharding`` in
    the tree ``specs`` does not shard.  A leaf split over an axis needs
    no sum there: its FSDP gather's backward summed the axis, or its
    block is the rank's own (tensor parallelism).  Small leaves with
    the same axes share one all-reduce."""
    mesh = current_mesh()
    if mesh is None:
        return
    live = spec_axes(P(tuple(partial)), mesh)
    groups: Dict[Tuple[str, ...], list] = {}
    for g, s in zip(leaves(grads), leaves(specs)):
        have = spec_axes(s.spec, mesh)
        axes = tuple(a for a in live if a not in have)
        if not axes:
            continue
        if g.numel() >= _COALESCE:
            dist.all_reduce(g, group=_group(axes, mesh))
        else:
            groups.setdefault(axes, []).append(g)
    for axes, gs in groups.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=_group(axes, mesh))
        lo = 0
        for g in gs:
            g.copy_(flat[lo:lo + g.numel()].view_as(g))
            lo += g.numel()
