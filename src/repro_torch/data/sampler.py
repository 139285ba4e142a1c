"""Fanout neighbor sampler for minibatch GNN training (GraphSAGE), the JAX
package's ``data/sampler.py`` (the same ``default_rng((seed, step))``
stream, so both packages draw the same block).

Samples a k-hop block from a CSR graph: hop 0 = the batch nodes, hop i =
up to ``fanout[i]`` random in-neighbors of each hop-(i-1) node.  The
result is re-indexed to a compact padded :class:`GraphBatch` whose static
shape is the worst case (batch·Πfanout); padding edges point at the
sentinel node ``max_n``.  Edges point child → parent (message flows
toward the batch nodes).  The sampling runs in numpy on the host; the
block is uploaded to ``device`` (default ``cuda``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..models.gnn.common import GraphBatch
from .graphs import _on


def block_shape(batch_nodes: int, fanout: Sequence[int]) -> Tuple[int, int]:
    """(nodes, edges) of a sampled block's static shape."""
    tot_n, tot_e = batch_nodes, 0
    layer = batch_nodes
    for f in fanout:
        layer = layer * f
        tot_e += layer
        tot_n += layer
    return tot_n, tot_e


@dataclasses.dataclass
class NeighborSampler:
    ptr: np.ndarray       # CSR in-neighbor pointers [N+1]
    nbr: np.ndarray       # CSR in-neighbor ids     [M]
    feats: np.ndarray     # [N, F] node features
    labels: np.ndarray    # [N]
    fanout: Sequence[int] = (15, 10)
    seed: int = 0
    device: Any = None    # where blocks go (default cuda)

    def block_shape(self, batch_nodes: int) -> Tuple[int, int]:
        return block_shape(batch_nodes, self.fanout)

    def sample(self, batch_ids: np.ndarray, step: int = 0) -> GraphBatch:
        device = resolve_device(self.device)
        rng = np.random.default_rng((self.seed, step))
        bsz = batch_ids.shape[0]
        max_n, max_e = self.block_shape(bsz)

        # node table: compact local ids; batch nodes first
        local = {int(v): i for i, v in enumerate(batch_ids)}
        order = list(int(v) for v in batch_ids)
        src_l, dst_l = [], []
        frontier = list(int(v) for v in batch_ids)
        for f in self.fanout:
            nxt = []
            for v in frontier:
                lo, hi = self.ptr[v], self.ptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = rng.choice(deg, size=take, replace=False)
                for p in picks:
                    u = int(self.nbr[lo + p])
                    if u not in local:
                        local[u] = len(order)
                        order.append(u)
                        nxt.append(u)
                    src_l.append(local[u])
                    dst_l.append(local[v])
            frontier = nxt

        n_real = len(order)
        e_real = len(src_l)
        feat = np.zeros((max_n, self.feats.shape[1]), np.float32)
        feat[:n_real] = self.feats[order]
        labels = np.zeros(max_n, np.int32)
        labels[:n_real] = self.labels[order]
        mask = np.zeros(max_n, bool)
        mask[:bsz] = True                      # loss only on batch nodes
        src = np.full(max_e, max_n, np.int32)  # sentinel pad
        dst = np.full(max_e, max_n, np.int32)
        src[:e_real] = src_l
        dst[:e_real] = dst_l
        vec = np.zeros((max_e, 3), np.float32)
        vec[:, 2] = 1.0                        # unit stub geometry
        return GraphBatch(n_nodes=max_n, n_graphs=1,
                          src=_on(src, device), dst=_on(dst, device),
                          node_feat=_on(feat, device),
                          edge_feat=_on(vec, device),
                          graph_ids=None,
                          labels=_on(labels, device),
                          train_mask=_on(mask, device))


def csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray):
    """In-neighbor CSR: for each node, the sources of its incoming edges."""
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, dst_s + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, src_s
