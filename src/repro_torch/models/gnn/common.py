"""Shared GNN substrate of the port: padded graph batches and segment
primitives (the JAX package's ``models/gnn/common.py`` in torch).

Padding edges point at the sentinel node ``n`` (id == ``n_nodes``).
JAX reads them with ``jnp.take(..., fill_value=...)`` and writes them
into one scrap row that is sliced off.  Here every gather reads from the
source with one fill row appended (:func:`take`), and every scatter adds
into ``n + 1`` rows; an index is never clamped (a sentinel clamped to
``n - 1`` would read and write a real node).

Under a mesh with a live ``"nodes"`` axis (``rules_gnn``: every mesh
axis, flat) a model runs on this rank's blocks: node tensors are rows
``[i n / S, (i + 1) n / S)`` of the whole (``S`` ranks, ``i`` this
rank's index over the node axes), edge tensors an even share of the
edges, whose endpoints stay global ids, and ``GraphBatch.n_nodes`` the
whole (padded) count.  Each primitive then spells out the reduction
GSPMD lowers it to: a node tensor read at edge endpoints is gathered
whole first (:func:`gather_nodes`, an ``all_gather``), an edge-to-node
sum is built whole and cut back to node blocks (:func:`scatter_nodes`,
a ``psum_scatter``), and a readout over graphs or a masked mean over
nodes is a ``psum`` over the node axes, whole on every rank.  Without
those axes every primitive is the unsharded function.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ... import shardlib as sl
from ...shardlib import P
from ...tree import map_tree, register_dataclass
from ..common import mlp, mlp_init  # noqa: F401  (the JAX module's helpers)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Static-shape graph (or packed batch of graphs).

    ``src``/``dst`` are edge endpoints; padding edges point at the
    sentinel node ``n_nodes``.  ``graph_ids`` maps nodes to graphs for
    packed molecule batches.  The counts are plain ints, the rest tensors
    on one device.
    """
    n_nodes: int
    n_graphs: int
    src: torch.Tensor                             # [E] int32
    dst: torch.Tensor                             # [E] int32
    node_feat: torch.Tensor                       # [N, F] (or int atom types)
    edge_feat: Optional[torch.Tensor] = None      # [E, ...] dist / vectors
    graph_ids: Optional[torch.Tensor] = None      # [N] int32
    labels: Optional[torch.Tensor] = None         # [N] or [G]
    train_mask: Optional[torch.Tensor] = None     # [N] bool

    TENSORS = ("src", "dst", "node_feat", "edge_feat", "graph_ids", "labels",
               "train_mask")

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in self.TENSORS
            if getattr(self, k) is not None})


# the JAX module's register_dataclass: a tree of the data fields, in this
# order (a cell's sharding tree is a GraphBatch of NamedShardings)
register_dataclass(GraphBatch, GraphBatch.TENSORS)


# ---------------------------------------------------------------------------
# node and edge blocks under a mesh
# ---------------------------------------------------------------------------

def node_axes() -> Tuple[str, ...]:
    """The mesh axes the node and edge blocks split over under the
    current rules (() without a mesh, or under rules with no "nodes")."""
    if sl.current_mesh() is None:
        return ()
    return sl._live_axes("nodes")


def edge_count(g: "GraphBatch") -> int:
    """The whole graph's edge count: ``g``'s (its block under a mesh)
    times the ranks the edges split over.  Every model chunks by it, as
    the JAX cell's scan chunks the whole edge list."""
    e = g.src.shape[0]
    if sl.current_mesh() is None:
        return e
    return e * sl.axis_size(sl._live_axes("edges"))


def gather_nodes(x: torch.Tensor) -> torch.Tensor:
    """The whole node tensor from this rank's block (``all_gather`` over
    the node axes; its backward a ``psum_scatter``); ``x`` itself
    without them."""
    return sl.all_gather(x, node_axes(), axis=0)


def scatter_nodes(full: torch.Tensor) -> torch.Tensor:
    """This rank's node block of the ranks' summed whole node tensors
    (``psum_scatter`` over the node axes; its backward an
    ``all_gather``); ``full`` itself without them."""
    return sl.psum_scatter(full, node_axes(), 0)


def at_edges(x: torch.Tensor, index: torch.Tensor,
             fill: float = 0.0) -> torch.Tensor:
    """The node tensor ``x`` (a block under a mesh) at the edge
    endpoints ``index`` (global ids; the sentinel reads ``fill``)."""
    return take(gather_nodes(x), index, fill)


def once(tree):
    """``tree``'s tensors for work that every rank of the node axes
    repeats on whole tensors (a head after a graph readout): as they are
    on the first rank, detached on the others, so that the sum of the
    ranks' gradients over the node axes (``reduce_grads``) counts that
    work once.  ``tree`` itself without node axes."""
    axes = node_axes()
    if not axes or sl.axis_index(axes) == 0:
        return tree
    return map_tree(lambda t: t.detach(), tree)


class _AddRows(torch.autograd.Function):
    """``acc[index] += values`` along dim 0, in place, keeping only
    ``index`` for backward.  ``Tensor.index_add_``'s own backward keeps
    ``values`` alive (its formula reads their shape from them), which
    would hold every chunk's messages until backward, the memory
    :func:`chunked_scatter_sum` exists to save; JAX's transposed scatter
    keeps none."""

    @staticmethod
    def forward(ctx, acc, index, values):
        ctx.mark_dirty(acc)
        ctx.save_for_backward(index)
        return acc.index_add_(0, index, values)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        return grad, None, grad.index_select(0, index)


def add_rows_(acc: torch.Tensor, index: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``acc[index] += values`` (repeated indices add up), in place and
    differentiable; returns ``acc``."""
    return _AddRows.apply(acc, index, values)


def take(x: torch.Tensor, index: torch.Tensor, fill: float = 0.0
         ) -> torch.Tensor:
    """Rows ``index`` of ``x`` along dim 0, and ``fill`` for index
    ``x.shape[0]`` (the sentinel): ``jnp.take(x, index, axis=0,
    fill_value=fill)`` for indices in ``[0, n]``."""
    return extend(x, fill).index_select(0, index)


def extend(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``x`` with one row of ``fill`` appended: the source of a gather
    whose sentinel index reads ``fill`` (build it once when several
    gathers read the same ``x``)."""
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), fill)])


def edge_chunks(n_chunks: int, *arrays, sentinel: int = 0):
    """Reshape [E, ...] edge arrays to [n_chunks, E/n_chunks, ...] (padding
    int arrays with ``sentinel``, float arrays with 0)."""
    e = arrays[0].shape[0]
    per = -(-e // n_chunks)
    pad = per * n_chunks - e
    out = []
    for a in arrays:
        if pad:
            cv = sentinel if not a.dtype.is_floating_point else 0
            a = torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), cv)])
        out.append(a.reshape((n_chunks, per) + tuple(a.shape[1:])))
    return out


def chunked_scatter_sum(edge_fn: Callable, n_chunks: int, arrays, n: int,
                        out_shape: Sequence[int], dtype: torch.dtype,
                        dst_ranged: bool = False) -> torch.Tensor:
    """Accumulate scatter-sums over edge chunks.

    ``edge_fn(*chunk_arrays) -> (values [e_c, ...], dst [e_c])``; values
    are scatter-added into an [n(+1 scrap), ...] accumulator chunk by
    chunk, so the per-edge intermediate never exceeds one chunk.  Each
    chunk's ``edge_fn`` runs under ``torch.utils.checkpoint``: backward
    recomputes it, and no chunk's [e_c, F] messages outlive its add (the
    JAX function's ``jax.checkpoint`` on the scan body).  The adds go
    into one accumulator in place, in chunk order.  Under a mesh the
    rank's edges go in ``n_chunks`` chunks (the whole edge list's count)
    into a whole accumulator, cut back to node blocks at the end
    (:func:`scatter_nodes`).

    ``dst_ranged``: edges are pre-bucketed so chunk i's destinations fall
    in node range [i·(n/n_chunks), (i+1)·(n/n_chunks)); each chunk scatters
    into a range-sized local buffer (its scrap row takes the rest) and the
    buffers are concatenated.  No body remat on this branch, as in JAX.
    Under a mesh of S ranks over the nodes a rank holds the chunks
    ``[i n_chunks / S, (i + 1) n_chunks / S)``, whose ranges make up its
    node block: no collective at all.  The chunks must fall whole in
    the node blocks (``n_chunks`` a multiple of S, ``n`` of
    ``n_chunks``), or this raises.
    """
    out_shape = tuple(out_shape)
    dev = arrays[0].device
    if not dst_ranged:
        chunked = edge_chunks(n_chunks, *arrays, sentinel=n)
        acc = torch.zeros((n + 1,) + out_shape, dtype=dtype, device=dev)
        for i in range(n_chunks):
            vals, dst = checkpoint(edge_fn, *(c[i] for c in chunked),
                                   use_reentrant=False)
            acc = add_rows_(acc, dst, vals.to(dtype))
        return scatter_nodes(acc[:n])

    axes = node_axes()
    ranks = sl.axis_size(axes)
    rng_sz = -(-n // n_chunks)
    if ranks > 1 and (n_chunks % ranks or rng_sz * n_chunks != n):
        raise ValueError(
            f"dst_ranged: {n_chunks} chunks of {n} nodes do not fall whole "
            f"in the node blocks of {ranks} ranks over {axes}")
    mine = n_chunks // ranks
    first = sl.axis_index(axes) * mine
    chunked = edge_chunks(mine, *arrays, sentinel=n)
    bufs = []
    for i in range(mine):
        vals, dst = edge_fn(*(c[i] for c in chunked))
        local = dst - (first + i) * rng_sz
        ok = (local >= 0) & (local < rng_sz)
        local = torch.where(ok, local, rng_sz)      # scrap row
        buf = torch.zeros((rng_sz + 1,) + out_shape, dtype=dtype, device=dev)
        bufs.append(add_rows_(buf, local, vals.to(dtype))[:rng_sz])
    return torch.cat(bufs)[:n // ranks]


def partitioned_aggregate(x: torch.Tensor, arrays, edge_fn: Callable,
                          n: int, out_shape: Sequence[int],
                          dtype: torch.dtype, n_chunks: int = 1
                          ) -> torch.Tensor:
    """Owner-partitioned message passing.

    Precondition (data layout): the ``arrays`` edge arrays are ordered
    so shard k holds exactly the edges whose *destination* lives in node
    shard k (``bucket_edges_by_dst``).  Under a mesh with a live
    "nodes" axis, ``x`` and ``arrays`` are this rank's blocks (nodes and
    edges split evenly over that axis): one ``all_gather`` of the node
    features, then a local gather, ``edge_fn`` and an add into the local
    node slice, whose scrap row takes every destination outside it.
    Without one, the same body on the whole graph at offset 0.
    ``edge_fn(x_full, *chunk_arrays) -> (values, global_dst)``; each
    chunk (or the whole edge list when ``n_chunks <= 1``) is
    rematerialised in backward.
    """
    axes = sl._live_axes("nodes")
    if sl.current_mesh() is None or not axes:
        # a view: the chunks' gradients sum into it before they meet the
        # rest of x's (the order the mapped branch's all_gather gives)
        return _owner_aggregate(x.view_as(x), x.shape[0], 0, arrays,
                                edge_fn, n, out_shape, dtype, n_chunks)

    def inner(x_l, *arr_l):
        return _owner_aggregate(sl.all_gather(x_l, axes, axis=0),
                                x_l.shape[0],
                                sl.axis_index(axes) * x_l.shape[0], arr_l,
                                edge_fn, n, out_shape, dtype, n_chunks)

    ax = axes if len(axes) > 1 else axes[0]
    fn = sl.maybe_shard_map(
        inner,
        in_specs=tuple(P(ax, *([None] * (a.dim() - 1)))
                       for a in (x,) + tuple(arrays)),
        out_specs=P(ax, *([None] * len(out_shape))))
    return fn(x, *arrays)


def _owner_aggregate(x_full, n_local: int, offset: int, arrays, edge_fn,
                     n: int, out_shape, dtype, n_chunks: int):
    """Messages of ``arrays``' edges into nodes ``[offset, offset +
    n_local)``: ``edge_fn`` on ``x_full``, a destination outside the
    slice to the scrap row with its values zeroed, chunk by chunk."""
    out_shape = tuple(out_shape)

    def chunk_body(*chunk):
        vals, dst = edge_fn(x_full, *chunk)
        local = dst - offset
        ok = (local >= 0) & (local < n_local)
        local = torch.where(ok, local, n_local)
        keep = ok.reshape((-1,) + (1,) * (vals.dim() - 1)).to(vals.dtype)
        return vals * keep, local

    acc = torch.zeros((n_local + 1,) + out_shape, dtype=dtype,
                      device=x_full.device)
    chunks = ([[a] for a in arrays] if n_chunks <= 1
              else edge_chunks(n_chunks, *arrays, sentinel=n))
    for i in range(max(n_chunks, 1)):
        vals, local = checkpoint(chunk_body, *(c[i] for c in chunks),
                                 use_reentrant=False)
        acc = add_rows_(acc, local, vals.to(dtype))
    return acc[:n_local]


def _scatter_rows(values: torch.Tensor, index: torch.Tensor,
                  n: int) -> torch.Tensor:
    """segment-sum of ``values`` [E, ...] into ``n`` rows (+1 scrap row),
    on this rank's values alone."""
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    return add_rows_(out, index, values)[:n]


def _max_rows(values: torch.Tensor, index: torch.Tensor, n: int,
              fill: float) -> torch.Tensor:
    out = values.new_full((n + 1,) + tuple(values.shape[1:]), fill)
    idx = index.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=True)[:n]


def scatter_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """segment-sum of ``values`` [E, ...] into ``n`` rows (+1 scrap row);
    under a mesh, edge values into this rank's node block."""
    return scatter_nodes(_scatter_rows(values, index, n))


def scatter_max(values: torch.Tensor, index: torch.Tensor, n: int,
                fill: float = -float("inf")) -> torch.Tensor:
    """segment-max into ``n`` rows; under a mesh, edge values into this
    rank's node block (a ``pmax`` of the whole, no gradient)."""
    axes = node_axes()
    full = sl.pmax(_max_rows(values, index, n, fill), axes)
    return full.chunk(sl.axis_size(axes))[sl.axis_index(axes)]


def gather_scatter_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       n: int, edge_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The SpMM core: out[dst] += w * x[src], static shapes, sentinel-safe
    (under a mesh, ``x`` and the result node blocks)."""
    msgs = at_edges(x, src)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None].to(msgs.dtype)
    return scatter_sum(msgs, dst, n)


def segment_softmax(logits: torch.Tensor, index: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Softmax over edges grouped by ``index`` (per-destination); under a
    mesh over every rank's edges of a destination (the maxima by
    ``pmax``, the sums cut to node blocks and gathered whole)."""
    m = sl.pmax(_max_rows(logits, index, n, -float("inf")), node_axes())
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - take(m, index))
    z = gather_nodes(scatter_sum(p, index, n))
    z = take(torch.clamp(z, min=1e-30), index, fill=1.0)
    return p / z


def degrees(index: torch.Tensor, n: int) -> torch.Tensor:
    """In-degrees of the ``n`` nodes (under a mesh, this rank's block)."""
    return scatter_sum(torch.ones(index.shape[0], dtype=torch.float32,
                                  device=index.device), index, n)


def graph_readout(x: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int,
                  op: str = "sum") -> torch.Tensor:
    """Per-graph sum (or mean) of the node rows ``x``; under a mesh the
    node blocks' sums ``psum``-ed over the node axes, whole on every
    rank."""
    axes = node_axes()
    s = sl.psum(_scatter_rows(x, graph_ids, n_graphs), axes)
    if op == "sum":
        return s
    ones = torch.ones(graph_ids.shape[0], dtype=torch.float32,
                      device=graph_ids.device)
    cnt = torch.clamp(sl.psum(_scatter_rows(ones, graph_ids, n_graphs),
                              axes), min=1.0)
    return s / cnt[:, None]


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over the rows where ``mask`` holds (at least 1
    in the denominator); under a mesh over every rank's node block (the
    masked sum and the count ``psum``-ed), whole on every rank."""
    axes = node_axes()
    m = mask.to(values.dtype)
    return sl.psum((values * m).sum(), axes) / torch.clamp(
        sl.psum(mask.sum(), axes), min=1)


def n_edge_chunks(n_edges: int, edge_chunk: int) -> int:
    """Chunks of at most ``edge_chunk`` edges (1 when chunking is off or
    the edges fit in one), as every model's forward computes it."""
    return -(-n_edges // edge_chunk) if edge_chunk and n_edges > edge_chunk \
        else 1
