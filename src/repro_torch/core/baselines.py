"""Competitor methods from the paper's experiments (§7).

* :func:`em_dijkstra`  — EM-Dijk [18]: Dijkstra over disk-resident adjacency
  lists with a bounded block cache; every cache miss is a *random* block
  access. This exposes the paper's core complaint: visit order diverges
  from storage order.
* :func:`em_bfs`       — EM-BFS [6] (Munagala–Ranade flavor): level-by-level
  frontier expansion with external sorts; unweighted graphs only.
* :class:`VCIndex`     — VC-Index [8]: vertex-cover hierarchy for undirected
  graphs. Non-cover nodes form an independent set, so removing them while
  cliquing their (cover) neighbors preserves cover-to-cover distances;
  queries resolve top-down with sequential scans per level. This is a
  faithful simplification of Cheng et al.'s index (same reduction
  invariant, same scan-oriented I/O pattern).

All methods meter their I/O through :class:`~repro_torch.core.io_sim.BlockDevice`
so benchmarks can compare modeled disk time next to CPU time.  A copy of
the JAX package's ``core/baselines.py``: host code (numpy, heaps), the
same distances and the same ``IOStats``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .graph import Digraph
from .io_sim import BlockDevice, IOStats

__all__ = ["em_dijkstra", "em_bfs", "VCIndex"]

EDGE_BYTES = 12  # (dst int64-ish, w float32) packed on disk


# ---------------------------------------------------------------------------
# EM-Dijkstra
# ---------------------------------------------------------------------------

def em_dijkstra(g: Digraph, source: int, device: Optional[BlockDevice] = None,
                cache_blocks: int = 4096) -> Tuple[np.ndarray, IOStats]:
    """Dijkstra with an LRU-cached block view of the CSR adjacency file."""
    device = device or BlockDevice()
    block_edges = max(1, device.block_bytes // EDGE_BYTES)
    cache: OrderedDict[int, None] = OrderedDict()

    def touch(node: int) -> None:
        lo, hi = int(g.out_ptr[node]), int(g.out_ptr[node + 1])
        for blk in range(lo // block_edges, max(lo, hi - 1) // block_edges + 1):
            if blk in cache:
                cache.move_to_end(blk)
                continue
            device.random(device.block_bytes)
            cache[blk] = None
            if len(cache) > cache_blocks:
                cache.popitem(last=False)

    n = g.n
    dist = np.full(n, np.inf, dtype=np.float64)
    dist[source] = 0.0
    heap = [(0.0, source)]
    while heap:
        d_u, u = heapq.heappop(heap)
        if d_u > dist[u]:
            continue
        touch(u)
        dsts, ws = g.out_edges(u)
        for v, wv in zip(dsts.tolist(), ws.tolist()):
            nd = d_u + wv
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist, device.stats


# ---------------------------------------------------------------------------
# EM-BFS (unweighted)
# ---------------------------------------------------------------------------

def em_bfs(g: Digraph, source: int,
           device: Optional[BlockDevice] = None) -> Tuple[np.ndarray, IOStats]:
    """Munagala–Ranade external BFS: N(L_t) gathered (random I/O), then
    deduplicated against L_t, L_{t-1} via external sort + sequential scans."""
    device = device or BlockDevice()
    n = g.n
    dist = np.full(n, np.inf, dtype=np.float64)
    dist[source] = 0.0
    frontier = np.array([source], dtype=np.int64)
    prev = np.empty(0, dtype=np.int64)
    level = 0
    while frontier.size:
        level += 1
        # gather adjacency of the frontier — one random block hit per node
        neigh: List[np.ndarray] = []
        nbytes = 0
        for u in frontier.tolist():
            dsts, _ = g.out_edges(u)
            neigh.append(dsts)
            nbytes += max(1, dsts.size) * EDGE_BYTES
            device.random(min(nbytes, device.block_bytes))
        cand = (np.unique(np.concatenate(neigh)) if neigh
                else np.empty(0, dtype=np.int64))
        device.external_sort(cand.size * 8, mem_bytes=64 << 20)
        device.sequential((frontier.size + prev.size) * 8)
        new = cand[~np.isfinite(dist[cand])]
        dist[new] = level
        prev, frontier = frontier, new
    return dist, device.stats


# ---------------------------------------------------------------------------
# VC-Index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _VCLevel:
    # adjacency (to cover nodes) of every node removed at this level
    removed: np.ndarray                 # node ids
    adj: List[List[Tuple[int, float]]]  # parallel to `removed`
    nbytes: int


class VCIndex:
    """Vertex-cover hierarchy index for *undirected* graphs (VC-Index [8]).

    Build: repeatedly take a maximal-matching 2-approx vertex cover; the
    independent non-cover nodes (degree-capped to bound clique fill-in) are
    removed, their neighbor pairs cliqued with summed weights. Distances
    between surviving nodes are preserved exactly.
    """

    def __init__(self, g: Digraph, top_nodes: int = 2048, deg_cap: int = 8,
                 max_levels: int = 40,
                 device: Optional[BlockDevice] = None):
        self.device = device or BlockDevice()
        t0 = time.perf_counter()
        n = g.n
        adj: List[Dict[int, float]] = [dict() for _ in range(n)]
        src, dst, w = g.edge_list()
        for a, b, ww in zip(src.tolist(), dst.tolist(), w.tolist()):
            if adj[a].get(b, np.inf) > ww:
                adj[a][b] = ww
                adj[b][a] = ww
        self.device.sequential(g.m * EDGE_BYTES * 2)

        alive = np.ones(n, dtype=bool)
        self.levels: List[_VCLevel] = []
        n_alive = n
        for _ in range(max_levels):
            if n_alive <= top_nodes:
                break
            alive_ids = np.flatnonzero(alive)
            # maximal matching -> cover; unmatched nodes are independent
            in_cover = np.zeros(n, dtype=bool)
            for u in alive_ids.tolist():
                if in_cover[u]:
                    continue
                for v in adj[u]:
                    if not in_cover[v]:
                        in_cover[u] = True
                        in_cover[v] = True
                        break
            removable = [int(v) for v in alive_ids.tolist()
                         if not in_cover[v] and len(adj[v]) <= deg_cap]
            if not removable:
                break
            rem_adj: List[List[Tuple[int, float]]] = []
            nbytes = 0
            for v in removable:
                items = sorted(adj[v].items())
                rem_adj.append([(int(u), float(ww)) for u, ww in items])
                nbytes += len(items) * EDGE_BYTES
                # clique fill-in among neighbors (all in the cover)
                for i, (u, wu) in enumerate(items):
                    for (x, wx) in items[i + 1:]:
                        if u == x:
                            continue
                        nw = wu + wx
                        if adj[u].get(x, np.inf) > nw:
                            adj[u][x] = nw
                            adj[x][u] = nw
                for u, _ in items:
                    adj[u].pop(v, None)
                adj[v] = {}
                alive[v] = False
            self.device.sequential(nbytes)
            self.levels.append(_VCLevel(np.asarray(removable, dtype=np.int64),
                                        rem_adj, nbytes))
            n_alive -= len(removable)

        self.top_nodes_ids = np.flatnonzero(alive)
        self.top_adj = {int(u): dict(adj[u]) for u in self.top_nodes_ids}
        self.top_bytes = sum(len(a) for a in self.top_adj.values()) * EDGE_BYTES
        self.n = n
        self.build_seconds = time.perf_counter() - t0
        self.build_io = self.device.reset()

    def index_bytes(self) -> int:
        return sum(l.nbytes for l in self.levels) + self.top_bytes

    def ssd(self, source: int) -> Tuple[np.ndarray, IOStats]:
        n = self.n
        dist = np.full(n, np.inf, dtype=np.float64)
        dist[source] = 0.0
        # upward: every removed node with a finite tentative distance seeds
        # its (surviving, cover) neighbors. Monotone-chain argument: some
        # shortest path to any survivor ascends removal levels, so one
        # ascending pass suffices for exact top-level seeds.
        for lvl in self.levels:
            self.device.sequential(lvl.nbytes)
            for i, v in enumerate(lvl.removed.tolist()):
                dv = dist[v]
                if not np.isfinite(dv):
                    continue
                for (u, wu) in lvl.adj[i]:
                    if dv + wu < dist[u]:
                        dist[u] = dv + wu
        # top level: in-memory Dijkstra over the residual graph
        heap = [(float(dist[u]), int(u)) for u in self.top_nodes_ids
                if np.isfinite(dist[u])]
        heapq.heapify(heap)
        self.device.sequential(self.top_bytes)
        while heap:
            d_u, u = heapq.heappop(heap)
            if d_u > dist[u]:
                continue
            for v, wv in self.top_adj[u].items():
                nd = d_u + wv
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
        # downward: removed nodes resolve from their (cover) neighbors,
        # one sequential scan per level, highest level first
        for lvl in reversed(self.levels):
            self.device.sequential(lvl.nbytes)
            for i, v in enumerate(lvl.removed.tolist()):
                best = dist[v]
                for (u, wu) in lvl.adj[i]:
                    cand = dist[u] + wu
                    if cand < best:
                        best = cand
                dist[v] = best
        return dist, self.device.reset()
