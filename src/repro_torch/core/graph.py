"""Weighted directed graph substrate for HoD.

The paper (§2) assumes a directed, positively-weighted graph stored on disk
as adjacency lists with every edge recorded twice (once per endpoint, the
reverse copy carrying a negated length).  In this system the canonical
in-memory form is CSR (out-edges) + CSC (in-edges) over numpy arrays; the
"two copies" trick of §4.1 reappears in :mod:`repro.core.build` as signed
triplets during the sort-merge.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np

__all__ = [
    "Digraph",
    "from_edges",
    "gnm_random_digraph",
    "power_law_digraph",
    "grid_road_graph",
    "symmetrize",
    "largest_weakly_connected_component",
]


@dataclasses.dataclass
class Digraph:
    """CSR/CSC weighted digraph. Node ids are 0..n-1; weights positive f64."""

    n: int
    # CSR over out-edges
    out_ptr: np.ndarray   # [n+1] int64
    out_dst: np.ndarray   # [m]   int64
    out_w: np.ndarray     # [m]   float64
    # CSC over in-edges (mirrors the same edge set)
    in_ptr: np.ndarray    # [n+1] int64
    in_src: np.ndarray    # [m]   int64
    in_w: np.ndarray      # [m]   float64

    @property
    def m(self) -> int:
        return int(self.out_dst.shape[0])

    def out_edges(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.out_ptr[v], self.out_ptr[v + 1]
        return self.out_dst[s:e], self.out_w[s:e]

    def in_edges(self, v: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.in_ptr[v], self.in_ptr[v + 1]
        return self.in_src[s:e], self.in_w[s:e]

    def edge_list(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (src, dst, w) arrays of length m."""
        src = np.repeat(np.arange(self.n, dtype=np.int64),
                        np.diff(self.out_ptr))
        return src, self.out_dst.copy(), self.out_w.copy()

    def reverse(self) -> "Digraph":
        """Transpose — supports the paper's destination-node formulation."""
        src, dst, w = self.edge_list()
        return from_edges(self.n, dst, src, w)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in (self.out_ptr, self.out_dst, self.out_w,
                                      self.in_ptr, self.in_src, self.in_w))

    def to_networkx(self):
        import networkx as nx

        g = nx.DiGraph()
        g.add_nodes_from(range(self.n))
        src, dst, w = self.edge_list()
        g.add_weighted_edges_from(zip(src.tolist(), dst.tolist(), w.tolist()))
        return g


def from_edges(n: int, src: Iterable[int], dst: Iterable[int],
               w: Iterable[float], dedup: str = "min") -> Digraph:
    """Build a Digraph from parallel edge arrays.

    Parallel edges collapse to the shortest one (``dedup="min"``); self loops
    are dropped (they never lie on a shortest path with positive weights).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    if src.size:
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
    if w.size and (w <= 0).any():
        raise ValueError("edge lengths must be positive (paper §2)")
    if src.size and dedup == "min":
        order = np.lexsort((w, dst, src))
        src, dst, w = src[order], dst[order], w[order]
        first = np.ones(src.shape[0], dtype=bool)
        first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst, w = src[first], dst[first], w[first]

    def _csr(key: np.ndarray, val: np.ndarray, vw: np.ndarray):
        order = np.argsort(key, kind="stable")
        key, val, vw = key[order], val[order], vw[order]
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(ptr, key + 1, 1)
        np.cumsum(ptr, out=ptr)
        return ptr, val, vw

    out_ptr, out_dst, out_w = _csr(src, dst, w)
    in_ptr, in_src, in_w = _csr(dst, src, w)
    return Digraph(n, out_ptr, out_dst, out_w, in_ptr, in_src, in_w)


def symmetrize(g: Digraph) -> Digraph:
    """Undirected view: add the reverse of every edge (paper's u-BTC prep)."""
    src, dst, w = g.edge_list()
    return from_edges(g.n, np.concatenate([src, dst]),
                      np.concatenate([dst, src]), np.concatenate([w, w]))


def largest_weakly_connected_component(g: Digraph) -> Digraph:
    """Restrict to the largest WCC and relabel (paper §7.1 does the same)."""
    # Union-find over the undirected edge set.
    parent = np.arange(g.n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    src, dst, w = g.edge_list()
    for a, b in zip(src.tolist(), dst.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = np.array([find(i) for i in range(g.n)], dtype=np.int64)
    vals, counts = np.unique(roots, return_counts=True)
    big = vals[np.argmax(counts)]
    keep = roots == big
    new_id = np.full(g.n, -1, dtype=np.int64)
    new_id[keep] = np.arange(keep.sum(), dtype=np.int64)
    mask = keep[src] & keep[dst]
    return from_edges(int(keep.sum()), new_id[src[mask]], new_id[dst[mask]],
                      w[mask])


# ---------------------------------------------------------------------------
# Generators (stand-ins for the paper's USRN / FB / BTC / Meme / UKWeb inputs)
# ---------------------------------------------------------------------------

def gnm_random_digraph(n: int, m: int, seed: int = 0,
                       weighted: bool = True) -> Digraph:
    """Erdős–Rényi style G(n, m) digraph with integer-ish positive weights."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=int(m * 1.2), dtype=np.int64)
    dst = rng.integers(0, n, size=int(m * 1.2), dtype=np.int64)
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    w = (rng.integers(1, 11, size=src.shape[0]).astype(np.float64)
         if weighted else np.ones(src.shape[0]))
    return from_edges(n, src, dst, w)


def power_law_digraph(n: int, m_per_node: int = 4, seed: int = 0,
                      weighted: bool = False) -> Digraph:
    """Preferential-attachment digraph — web/social-like (FB/Meme stand-in)."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    targets = np.arange(min(m_per_node, n), dtype=np.int64)
    repeated = list(targets)
    for v in range(len(targets), n):
        picks = rng.choice(len(repeated), size=min(m_per_node, len(repeated)),
                           replace=False)
        for p in picks:
            u = repeated[p]
            if rng.random() < 0.5:
                src_l.append(v); dst_l.append(u)
            else:
                src_l.append(u); dst_l.append(v)
            repeated.append(u)
        repeated.extend([v] * m_per_node)
    src = np.asarray(src_l, dtype=np.int64)
    dst = np.asarray(dst_l, dtype=np.int64)
    w = (rng.integers(1, 11, size=src.shape[0]).astype(np.float64)
         if weighted else np.ones(src.shape[0]))
    return from_edges(n, src, dst, w)


def grid_road_graph(side: int, seed: int = 0) -> Digraph:
    """4-connected grid with jittered weights — USRN (road network) stand-in.

    Degree-bounded and high-diameter, the regime where hierarchy/shortcut
    methods shine (paper §8 contrasts road networks vs. general graphs).
    """
    rng = np.random.default_rng(seed)
    n = side * side
    idx = np.arange(n, dtype=np.int64).reshape(side, side)
    src_l, dst_l = [], []
    right_s, right_d = idx[:, :-1].ravel(), idx[:, 1:].ravel()
    down_s, down_d = idx[:-1, :].ravel(), idx[1:, :].ravel()
    for s, d in ((right_s, right_d), (down_s, down_d)):
        src_l.append(s); dst_l.append(d)
        src_l.append(d); dst_l.append(s)
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    w = rng.integers(1, 6, size=src.shape[0]).astype(np.float64)
    return from_edges(n, src, dst, w)
