"""Graph dataset builders for the GNN cells (the JAX package's
``data/graphs.py``: the same numpy draws in the same order, so both
packages build the same graph, bit for bit, from the same seed).

Produces :class:`~repro_torch.models.gnn.common.GraphBatch` instances with
the exact node/edge counts of the assigned shapes, on ``device``
(default ``cuda``; raises without a card unless given ``"cpu"``).
Geometry-free graphs get a synthesized geometric frontend (random edge
vectors) so SchNet/Equiformer configs run on every shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.gnn.common import GraphBatch


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def make_graph_batch(n_nodes: int, n_edges: int, d_feat: int,
                     n_classes: int = 7, seed: int = 0,
                     feat_kind: str = "dense", n_graphs: int = 1,
                     with_geometry: bool = True,
                     train_frac: float = 0.1, device=None) -> GraphBatch:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    if feat_kind == "dense":
        feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    else:  # integer atom types
        feat = rng.integers(0, 90, n_nodes).astype(np.int32)
    edge_feat = None
    if with_geometry:
        vec = rng.normal(size=(n_edges, 3)).astype(np.float32)
        vec /= np.linalg.norm(vec, axis=1, keepdims=True) + 1e-9
        vec *= rng.uniform(0.8, 9.0, (n_edges, 1)).astype(np.float32)
        edge_feat = _on(vec, device)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    mask = rng.random(n_nodes) < train_frac
    gid = (None if n_graphs == 1 else
           _on(rng.integers(0, n_graphs, n_nodes).astype(np.int32), device))
    return GraphBatch(n_nodes=n_nodes, n_graphs=n_graphs,
                      src=_on(src, device), dst=_on(dst, device),
                      node_feat=_on(feat, device), edge_feat=edge_feat,
                      graph_ids=gid, labels=_on(labels, device),
                      train_mask=_on(mask, device))


def synth_feature_graph(name: str, seed: int = 0, device=None) -> GraphBatch:
    """Named stand-ins for the assigned full-graph shapes."""
    shapes = {
        "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                              n_classes=7),
        "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140,
                             d_feat=100, n_classes=47),
    }
    return make_graph_batch(seed=seed, device=device, **shapes[name])


def stub_edge_feat(n_edges: int, shape=()) -> np.ndarray:
    """f32 features of ``n_edges`` padding edges: zeros, or unit stub
    vectors along z for 3-vector features (a zero vector has no frame)."""
    ef = np.zeros((n_edges,) + tuple(shape), np.float32)
    if ef.ndim == 2 and ef.shape[1] == 3:
        ef[:, 2] = 1.0
    return ef


def bucket_edges_by_dst(g: GraphBatch, n_buckets: int,
                        pad_factor: float = 1.15) -> GraphBatch:
    """Reorder (and pad) edges into contiguous destination ranges.

    Bucket i holds the edges whose dst lies in node range
    [i·N/n_buckets, (i+1)·N/n_buckets), padded with sentinel edges to a
    uniform per-bucket count — the layout the ``dst_ranged`` and
    ``partitioned`` aggregation paths assume.  Raises if any bucket
    exceeds ``pad_factor``× the average (re-bucket with a node permutation
    in that case).  Runs on the host; the result lies on ``g``'s device.
    """
    n = g.n_nodes
    rng_sz = -(-n // n_buckets)
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    e = src.shape[0]
    bucket = np.minimum(dst // rng_sz, n_buckets - 1)
    counts = np.bincount(bucket, minlength=n_buckets)
    cap = int(np.ceil(e / n_buckets * pad_factor))
    if counts.max() > cap:
        raise ValueError(f"bucket imbalance {counts.max()} > cap {cap}; "
                         "permute node ids or raise pad_factor")
    order = np.argsort(bucket, kind="stable")
    new_e = cap * n_buckets
    ns = np.full(new_e, n, np.int32)
    nd = np.full(new_e, n, np.int32)
    ef = (stub_edge_feat(new_e, tuple(g.edge_feat.shape[1:]))
          if g.edge_feat is not None else None)
    src_s, dst_s = src[order], dst[order]
    efe = g.edge_feat.cpu().numpy()[order] if g.edge_feat is not None \
        else None
    start = 0
    for b in range(n_buckets):
        cnt = counts[b]
        ns[b * cap: b * cap + cnt] = src_s[start: start + cnt]
        nd[b * cap: b * cap + cnt] = dst_s[start: start + cnt]
        if ef is not None:
            ef[b * cap: b * cap + cnt] = efe[start: start + cnt]
        start += cnt
    dev = g.src.device
    return dataclasses.replace(
        g, src=_on(ns, dev), dst=_on(nd, dev),
        edge_feat=_on(ef, dev) if ef is not None else None)


def synth_molecule_batch(batch: int = 128, n_nodes: int = 30,
                         n_edges: int = 64, seed: int = 0,
                         n_classes: int = 2, device=None) -> GraphBatch:
    """Packed batch of small molecules (block-diagonal edge structure)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    total_n = batch * n_nodes
    srcs, dsts = [], []
    for g in range(batch):
        s = rng.integers(0, n_nodes, n_edges) + g * n_nodes
        d = rng.integers(0, n_nodes, n_edges) + g * n_nodes
        srcs.append(s)
        dsts.append(d)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    types = rng.integers(0, 20, total_n).astype(np.int32)
    vec = rng.normal(size=(src.shape[0], 3)).astype(np.float32)
    vec /= np.linalg.norm(vec, axis=1, keepdims=True) + 1e-9
    vec *= rng.uniform(0.8, 4.0, (src.shape[0], 1)).astype(np.float32)
    gid = np.repeat(np.arange(batch, dtype=np.int32), n_nodes)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    return GraphBatch(n_nodes=total_n, n_graphs=batch,
                      src=_on(src, device), dst=_on(dst, device),
                      node_feat=_on(types, device),
                      edge_feat=_on(vec, device),
                      graph_ids=_on(gid, device),
                      labels=_on(labels, device))
