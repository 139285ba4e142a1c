"""The plain reference: shortest distances from the benchmark's own arc
lists, worked out again without the program.

Label-correcting (Bellman-Ford) relaxation of every arc at once, over a
block of sources at a time, until no label moves: exact in float64 for
integer weights, and order-free, since min and an exact add are.  It
reads no index and imports nothing of the program; only torch and numpy.
On the card it works out 256 rows of a 40,000-node graph in about a
second, where a heap Dijkstra in Python takes tenths of a second a row.

``dtype`` other than float64 computes the same relaxation in that
precision: the precision control (``hodbench/control.py``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["shortest_distances", "ArcTable"]


def shortest_distances(n: int, src: np.ndarray, dst: np.ndarray,
                       w: np.ndarray, sources, device="cpu",
                       dtype=torch.float64, block: int = 64,
                       check_every: int = 16) -> np.ndarray:
    """``[len(sources), n]`` float64 distances (``inf`` where unreachable)
    from each source over the arcs ``src[i] -> dst[i]`` of length
    ``w[i]``; parallel arcs count by their shortest, self loops never
    shorten anything."""
    sources = np.asarray(sources, dtype=np.int64)
    out = np.empty((sources.shape[0], n), dtype=np.float64)
    if sources.size == 0:
        return out
    s_t = torch.from_numpy(np.asarray(src, np.int64)).to(device)
    d_t = torch.from_numpy(np.asarray(dst, np.int64)).to(device)
    w_t = torch.from_numpy(np.asarray(w, np.float64)).to(device, dtype)
    for lo in range(0, sources.shape[0], block):
        rows = torch.from_numpy(sources[lo:lo + block]).to(device)
        s = rows.shape[0]
        lab = torch.full((n, s), float("inf"), dtype=dtype, device=device)
        lab[rows, torch.arange(s, device=device)] = 0
        idx = d_t[:, None].expand(-1, s)
        while True:
            before = lab.clone()
            for _ in range(check_every):
                cand = lab.index_select(0, s_t) + w_t[:, None]
                lab.scatter_reduce_(0, idx, cand, "amin", include_self=True)
            if torch.equal(lab, before):
                break
        out[lo:lo + s] = lab.t().double().cpu().numpy()
    return out


class ArcTable:
    """The shortest arc ``u -> v`` of the graph, looked up by its ends:
    what a predecessor has to step along."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 w: np.ndarray):
        key = np.asarray(src, np.int64) * n + np.asarray(dst, np.int64)
        order = np.lexsort((np.asarray(w), key))
        key, w = key[order], np.asarray(w, np.float64)[order]
        first = np.ones(key.shape[0], dtype=bool)
        first[1:] = key[1:] != key[:-1]
        self.n, self.key, self.w = n, key[first], w[first]

    def weight(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Length of the shortest arc ``u[i] -> v[i]``, ``nan`` where
        there is none."""
        q = np.asarray(u, np.int64) * self.n + np.asarray(v, np.int64)
        pos = np.searchsorted(self.key, q)
        pos_c = np.minimum(pos, max(self.key.shape[0] - 1, 0))
        hit = (pos < self.key.shape[0]) & (self.key[pos_c] == q) \
            if self.key.size else np.zeros(q.shape, bool)
        out = np.full(q.shape, np.nan)
        out[hit] = self.w[pos_c[hit]]
        return out
