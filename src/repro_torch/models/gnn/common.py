"""Shared GNN substrate of the port: padded graph batches and segment
primitives (the JAX package's ``models/gnn/common.py`` in torch).

Padding edges point at the sentinel node ``n`` (id == ``n_nodes``).
JAX reads them with ``jnp.take(..., fill_value=...)`` and writes them
into one scrap row that is sliced off.  Here every gather reads from the
source with one fill row appended (:func:`take`), and every scatter adds
into ``n + 1`` rows; an index is never clamped (a sentinel clamped to
``n - 1`` would read and write a real node).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ... import shardlib as sl
from ...shardlib import P
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
    into one accumulator in place, in chunk order.

    ``dst_ranged``: edges are pre-bucketed so chunk i's destinations fall
    in node range [i·(n/n_chunks), (i+1)·(n/n_chunks)); each chunk scatters
    into a range-sized local buffer (its scrap row takes the rest) and the
    buffers are concatenated.  No body remat on this branch, as in JAX.
    """
    chunked = edge_chunks(n_chunks, *arrays, sentinel=n)
    out_shape = tuple(out_shape)
    dev = arrays[0].device
    if not dst_ranged:
        acc = torch.zeros((n + 1,) + out_shape, dtype=dtype, device=dev)
        for i in range(n_chunks):
            vals, dst = checkpoint(edge_fn, *(c[i] for c in chunked),
                                   use_reentrant=False)
            acc = add_rows_(acc, dst, vals.to(dtype))
        return acc[:n]

    rng_sz = -(-n // n_chunks)
    bufs = []
    for i in range(n_chunks):
        vals, dst = edge_fn(*(c[i] for c in chunked))
        local = dst - i * rng_sz
        ok = (local >= 0) & (local < rng_sz)
        local = torch.where(ok, local, rng_sz)      # scrap row
        buf = torch.zeros((rng_sz + 1,) + out_shape, dtype=dtype, device=dev)
        bufs.append(add_rows_(buf, local, vals.to(dtype))[:rng_sz])
    return torch.cat(bufs)[:n]


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
        return _owner_aggregate(x, x.shape[0], 0, arrays, edge_fn, n,
                                out_shape, dtype, n_chunks)

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


def scatter_sum(values: torch.Tensor, index: torch.Tensor,
                n: int) -> torch.Tensor:
    """segment-sum of ``values`` [E, ...] into ``n`` rows (+1 scrap row)."""
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    return add_rows_(out, index, values)[:n]


def scatter_max(values: torch.Tensor, index: torch.Tensor, n: int,
                fill: float = -float("inf")) -> torch.Tensor:
    out = values.new_full((n + 1,) + tuple(values.shape[1:]), fill)
    idx = index.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                              include_self=True)[:n]


def gather_scatter_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       n: int, edge_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The SpMM core: out[dst] += w * x[src], static shapes, sentinel-safe."""
    msgs = take(x, src)
    if edge_weight is not None:
        msgs = msgs * edge_weight[:, None].to(msgs.dtype)
    return scatter_sum(msgs, dst, n)


def segment_softmax(logits: torch.Tensor, index: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Softmax over edges grouped by ``index`` (per-destination)."""
    m = scatter_max(logits, index, n)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - take(m, index))
    z = scatter_sum(p, index, n)
    z = take(torch.clamp(z, min=1e-30), index, fill=1.0)
    return p / z


def degrees(index: torch.Tensor, n: int) -> torch.Tensor:
    return scatter_sum(torch.ones(index.shape[0], dtype=torch.float32,
                                  device=index.device), index, n)


def graph_readout(x: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int,
                  op: str = "sum") -> torch.Tensor:
    s = scatter_sum(x, graph_ids, n_graphs)
    if op == "sum":
        return s
    cnt = torch.clamp(degrees(graph_ids, n_graphs), min=1.0)
    return s / cnt[:, None]


def n_edge_chunks(n_edges: int, edge_chunk: int) -> int:
    """Chunks of at most ``edge_chunk`` edges (1 when chunking is off or
    the edges fit in one), as every model's forward computes it."""
    return -(-n_edges // edge_chunk) if edge_chunk and n_edges > edge_chunk \
        else 1
