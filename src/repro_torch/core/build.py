"""HoD index construction (paper §4): the reference builder and the
types it shares with :mod:`repro_torch.core.build_fast`.

A copy of the JAX package's ``core/build.py`` (host code, numpy and
dicts).  :func:`build_hod` iteratively removes low-score nodes from a
working copy of the graph, patching distances with shortcuts, until the
survivors (the *core graph*) are small.  Removed nodes' adjacency
snapshots stream to the forward file ``F_f`` (out-edges) and backward
file ``F_b`` (in-edges); the iteration in which a node dies is its
*rank*.  It draws from ``np.random.default_rng(cfg.seed)`` in the
reference's order, so both packages build the same ``BuildResult``;
``build_hod_fast`` is the vectorized builder the serving paths use, and
this one is kept for differential testing.

Faithfulness notes
------------------
* score (Eq. 1):  ``s(v) = |B_in|·|B_out \\ B_in| + |B_out|·|B_in \\ B_out|``
* threshold: approximated median over a node sample (§4.2)
* independent set: no two adjacent nodes removed in one round (§4.2)
* shortcut pruning: candidate vs. baseline triplets, sort-merge with the
  §4.1 ordering rules; baselines = coinciding direct edges + ``c·Σ s(v)``
  sampled two-hop paths through retained nodes, c = 5 (§4.3)
* termination: core fits the memory budget AND one more round shrinks the
  reduced graph by < 5 % (§4.4)
* SSSP annotations (§6): every augmented edge (u, w) carries the node that
  immediately precedes w on the u→w path it represents; shortcuts inherit
  the annotation of the (v, w) half they replace.

The external triplet sort is performed in memory but charged against the
:class:`~repro_torch.core.io_sim.BlockDevice` so the I/O-cost benchmarks
reflect the paper's accounting.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .graph import Digraph
from .io_sim import BlockDevice, IOStats

__all__ = ["BuildConfig", "BuildStats", "BuildResult", "TRIPLET_BYTES",
           "build_hod"]

TRIPLET_BYTES = 20  # (node, node, length) on disk: 2×int64 + float32


@dataclasses.dataclass
class BuildConfig:
    # Memory-budget analogue: the core graph must fit these bounds ("M").
    max_core_nodes: int = 1024
    max_core_edges: int = 1 << 16
    min_shrink: float = 0.05       # §4.4 keep-going threshold
    baseline_factor: int = 5       # c in §4.3
    median_sample: int = 1024      # §4.2 approximated median
    max_rounds: int = 64
    # cap on sampled two-hop baselines per round: keeps preprocessing
    # near-linear on huge rounds; extra (unpruned) shortcuts only cost
    # space, never correctness (§4.1 safety argument)
    max_baseline_per_round: int = 200_000
    # stop contracting when shortcut fill-in outweighs removals: if the
    # reduced graph's edge count exceeds this multiple of the smallest
    # edge count seen, further rounds only inflate the index (scale-free
    # graphs; road networks never trigger it).  The survivors become the
    # core, exactly as when the §4.4 memory condition fires.
    fill_stop_ratio: float = 3.0
    seed: int = 0


@dataclasses.dataclass
class BuildStats:
    rounds: int = 0
    removed: int = 0
    candidates_generated: int = 0
    shortcuts_added: int = 0
    baselines_sampled: int = 0
    build_seconds: float = 0.0
    io: IOStats = dataclasses.field(default_factory=IOStats)
    core_nodes: int = 0
    core_edges: int = 0
    f_edges: int = 0
    b_edges: int = 0


@dataclasses.dataclass
class BuildResult:
    """Raw build output, consumed by :mod:`repro_torch.core.index`."""

    n: int
    rank: np.ndarray                 # [n] 1-based round of removal; core = rounds+1
    removal_order: List[int]         # non-core nodes, round-major
    level_sizes: List[int]           # nodes removed per round
    # forward file: per removed node, its out-edges (dst, w, assoc) at death
    f_adj: List[List[Tuple[int, float, int]]]
    # backward file: per removed node, its in-edges (src, w, assoc) at death
    b_adj: List[List[Tuple[int, float, int]]]
    core_nodes: List[int]
    # core graph edges (u, v, w, assoc) in original ids
    core_edges: List[Tuple[int, int, float, int]]
    stats: BuildStats = dataclasses.field(default_factory=BuildStats)


def _scores(cands: np.ndarray, out_adj, in_adj) -> np.ndarray:
    s = np.empty(cands.shape[0], dtype=np.int64)
    for i, v in enumerate(cands):
        b_out = out_adj[v].keys()
        b_in = in_adj[v]
        n_out, n_in = len(b_out), len(b_in)
        inter = 0
        small, big = (b_out, b_in) if n_out <= n_in else (b_in, b_out)
        for x in small:
            if x in big:
                inter += 1
        s[i] = n_in * (n_out - inter) + n_out * (n_in - inter)
    return s


def build_hod(g: Digraph, cfg: Optional[BuildConfig] = None,
              device: Optional[BlockDevice] = None) -> BuildResult:
    cfg = cfg or BuildConfig()
    device = device or BlockDevice()
    rng = np.random.default_rng(cfg.seed)
    t0 = time.perf_counter()

    n = g.n
    # Working adjacency: out_adj[u][v] = (weight, assoc); in_adj[v] = {u}.
    out_adj: List[Dict[int, Tuple[float, int]]] = [dict() for _ in range(n)]
    in_adj: List[Set[int]] = [set() for _ in range(n)]
    src, dst, w = g.edge_list()
    for a, b, ww in zip(src.tolist(), dst.tolist(), w.tolist()):
        out_adj[a][b] = (ww, a)          # original edge: assoc = start point
        in_adj[b].add(a)
    device.sequential(g.m * TRIPLET_BYTES * 2)  # initial adjacency-list scan

    alive = np.ones(n, dtype=bool)
    rank = np.zeros(n, dtype=np.int64)
    removal_order: List[int] = []
    level_sizes: List[int] = []
    f_adj: List[List[Tuple[int, float, int]]] = [None] * n  # type: ignore
    b_adj: List[List[Tuple[int, float, int]]] = [None] * n  # type: ignore
    stats = BuildStats()

    n_alive = n
    m_alive = g.m
    m_min_seen = g.m
    rounds = 0
    while rounds < cfg.max_rounds:
        core_fits = (n_alive <= cfg.max_core_nodes
                     and m_alive <= cfg.max_core_edges)
        alive_ids = np.flatnonzero(alive)
        if alive_ids.size == 0:
            break

        # ---- Step 1: select R_i (score ≤ ~median, independent set) -------
        sample = (alive_ids if alive_ids.size <= cfg.median_sample else
                  rng.choice(alive_ids, size=cfg.median_sample, replace=False))
        thresh = float(np.median(_scores(sample, out_adj, in_adj)))
        scores = _scores(alive_ids, out_adj, in_adj)
        cand_mask = scores <= thresh
        cand_ids = alive_ids[cand_mask]
        cand_ids = cand_ids[np.argsort(scores[cand_mask], kind="stable")]

        blocked = np.zeros(n, dtype=bool)
        selected: List[int] = []
        for v in cand_ids.tolist():
            if blocked[v]:
                continue
            selected.append(v)
            blocked[v] = True
            for u in in_adj[v]:
                blocked[u] = True
            for u2 in out_adj[v]:
                blocked[u2] = True
        if not selected:
            break

        # ---- Step 2: candidate edges for every v* ∈ R_i -------------------
        # cand_best[(u, w)] = (length, assoc) keeping the shortest candidate.
        cand_best: Dict[Tuple[int, int], Tuple[float, int]] = {}
        n_cands = 0
        for v in selected:
            for u in in_adj[v]:
                w_uv = out_adj[u][v][0]
                for w_node, (w_vw, assoc_vw) in out_adj[v].items():
                    if w_node == u:
                        continue
                    length = w_uv + w_vw
                    n_cands += 1
                    key = (u, w_node)
                    prev = cand_best.get(key)
                    if prev is None or length < prev[0]:
                        cand_best[key] = (length, assoc_vw)
        stats.candidates_generated += n_cands

        # ---- Step 3: baseline edges ---------------------------------------
        # Group 1: direct edges between retained endpoints coinciding with a
        # candidate pair (sufficient for the sort-merge: other groups can
        # never eliminate a candidate).
        base_best: Dict[Tuple[int, int], float] = {}
        for (u, w_node) in cand_best:
            e = out_adj[u].get(w_node)
            if e is not None:
                base_best[(u, w_node)] = e[0]
        # Group 2: c·Σs(v) sampled two-hop paths through retained nodes.
        n_base = min(cfg.baseline_factor * max(1, len(cand_best)),
                     cfg.max_baseline_per_round)
        retained = alive_ids[~np.isin(alive_ids, np.asarray(selected))]
        if retained.size and n_base:
            deg = np.fromiter((len(out_adj[v]) + len(in_adj[v])
                               for v in retained), dtype=np.float64,
                              count=retained.size)
            tot = deg.sum()
            if tot > 0:
                mids = rng.choice(retained, size=n_base, p=deg / tot)
                sel_set = set(selected)
                for v in mids.tolist():
                    ins = in_adj[v]
                    outs = out_adj[v]
                    if not ins or not outs:
                        continue
                    u = next(iter(ins)) if len(ins) == 1 else \
                        list(ins)[rng.integers(len(ins))]
                    keys = list(outs.keys())
                    w_node = keys[rng.integers(len(keys))]
                    if u in sel_set or w_node in sel_set or u == w_node:
                        continue
                    length = out_adj[u][v][0] + outs[w_node][0]
                    key = (u, w_node)
                    if key in cand_best:  # only colliding groups matter
                        prev = base_best.get(key)
                        if prev is None or length < prev:
                            base_best[key] = length
                        stats.baselines_sampled += 1
        # Charge the external sort of all triplets (2 signed copies each).
        n_triplets = 2 * (n_cands + len(base_best))
        device.external_sort(n_triplets * TRIPLET_BYTES,
                             mem_bytes=64 << 20)

        # ---- Step 4: merge — retain candidates shorter than every baseline
        shortcuts: List[Tuple[int, int, float, int]] = []
        for (u, w_node), (length, assoc) in cand_best.items():
            base = base_best.get((u, w_node))
            if base is not None and base <= length:
                continue
            shortcuts.append((u, w_node, length, assoc))
        stats.shortcuts_added += len(shortcuts)

        # ---- Step 5: snapshot + delete R_i, stream to F_f / F_b ----------
        f_bytes = 0
        for v in selected:
            fo = [(d, wv, asc) for d, (wv, asc) in out_adj[v].items()]
            fb = [(u, out_adj[u][v][0], out_adj[u][v][1]) for u in in_adj[v]]
            f_adj[v] = fo
            b_adj[v] = fb
            f_bytes += (len(fo) + len(fb)) * TRIPLET_BYTES
            stats.f_edges += len(fo)
            stats.b_edges += len(fb)
        device.sequential(f_bytes)  # appends to F_f / F_b are sequential

        removed_edges = 0
        for v in selected:
            for d in out_adj[v]:
                in_adj[d].discard(v)
            for u in in_adj[v]:
                del out_adj[u][v]
                removed_edges += 1
            removed_edges += len(out_adj[v])
            out_adj[v] = {}
            in_adj[v] = set()
            alive[v] = False
            rank[v] = rounds + 1
        removal_order.extend(selected)
        level_sizes.append(len(selected))

        # ---- Step 6: install retained shortcuts ---------------------------
        added_edges = 0
        for (u, w_node, length, assoc) in shortcuts:
            prev = out_adj[u].get(w_node)
            if prev is None:
                out_adj[u][w_node] = (length, assoc)
                in_adj[w_node].add(u)
                added_edges += 1
            elif length < prev[0]:
                out_adj[u][w_node] = (length, assoc)

        rounds += 1
        removed_frac = len(selected) / n_alive
        n_alive -= len(selected)
        m_alive += added_edges - removed_edges
        m_min_seen = min(m_min_seen, m_alive)
        stats.removed += len(selected)
        if core_fits and removed_frac < cfg.min_shrink:
            break
        if m_alive > cfg.fill_stop_ratio * max(m_min_seen, 1):
            break  # fill-in dominates: survivors become the core

    # ---- Core graph ------------------------------------------------------
    core_nodes = np.flatnonzero(alive).tolist()
    rank[alive] = rounds + 1
    core_edges: List[Tuple[int, int, float, int]] = []
    for u in core_nodes:
        for v, (wv, asc) in out_adj[u].items():
            core_edges.append((u, v, wv, asc))

    stats.rounds = rounds
    stats.core_nodes = len(core_nodes)
    stats.core_edges = len(core_edges)
    stats.build_seconds = time.perf_counter() - t0
    stats.io = device.stats

    return BuildResult(n=n, rank=rank, removal_order=removal_order,
                       level_sizes=level_sizes, f_adj=f_adj, b_adj=b_adj,
                       core_nodes=core_nodes, core_edges=core_edges,
                       stats=stats)
