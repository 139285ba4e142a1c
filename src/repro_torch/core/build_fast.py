"""Vectorized HoD preprocessing — the paper's sort-merge, done in numpy.

Semantically equivalent to :mod:`repro.core.build` (same §4 algorithm,
same invariants, same BuildResult contract) but every per-edge loop is
replaced by array ops, which is *more* faithful to the paper than the
dict-based reference: the paper's preprocessing is explicitly an
external-memory **sort-merge over edge triplets**, and ``np.lexsort`` is
that sort.  ~50-100× faster in this container; the reference
implementation is kept for differential testing.

Differences (documented, correctness-neutral):
* independent-set selection uses one Luby round over the candidate-induced
  subgraph (random priorities, local minima win) instead of the reference's
  sequential greedy scan — still an independent set, so the §4.2 "never
  remove two adjacent nodes" invariant holds; the paper does not specify
  tie-breaking.
* the two-hop baseline sample is drawn fully vectorized (edge-endpoint
  sampling ≙ degree-proportional node sampling, as §4.3 prescribes).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from .build import BuildConfig, BuildResult, BuildStats, TRIPLET_BYTES
from .graph import Digraph
from .io_sim import BlockDevice

__all__ = ["build_hod_fast"]


def _dedup_min(src, dst, w, assoc):
    """Keep the shortest copy of every (src, dst) edge."""
    if src.size == 0:
        return src, dst, w, assoc
    order = np.lexsort((w, dst, src))
    src, dst, w, assoc = src[order], dst[order], w[order], assoc[order]
    first = np.ones(src.size, bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    return src[first], dst[first], w[first], assoc[first]


def _scores_vectorized(n, src, dst, alive):
    """Eq. 1 scores for every alive node (exact, including intersections).

    |B_in ∩ B_out|(v) = number of neighbors u with edges in both
    directions — counted by canonical-pair grouping.
    """
    out_deg = np.bincount(src, minlength=n)
    in_deg = np.bincount(dst, minlength=n)
    a = np.minimum(src, dst)
    b = np.maximum(src, dst)
    fwd = src < dst
    key = a.astype(np.int64) * n + b
    order = np.argsort(key, kind="stable")
    k_s = key[order]
    f_s = fwd[order]
    grp = np.ones(k_s.size, bool)
    if k_s.size:
        grp[1:] = k_s[1:] != k_s[:-1]
    gid = np.cumsum(grp) - 1
    n_grp = gid[-1] + 1 if k_s.size else 0
    has_f = np.zeros(n_grp, bool)
    has_b = np.zeros(n_grp, bool)
    np.logical_or.at(has_f, gid, f_s)
    np.logical_or.at(has_b, gid, ~f_s)
    bidir = has_f & has_b
    # endpoints of each group
    firsts = np.flatnonzero(grp)
    ga = (k_s[firsts] // n).astype(np.int64)
    gb = (k_s[firsts] % n).astype(np.int64)
    inter = np.zeros(n, np.int64)
    np.add.at(inter, ga[bidir], 1)
    np.add.at(inter, gb[bidir], 1)
    s = in_deg * (out_deg - inter) + out_deg * (in_deg - inter)
    return np.where(alive, s, np.iinfo(np.int64).max)


def _luby_select(n, src, dst, cand_mask, rng):
    """One Luby round: candidates that beat every candidate neighbor."""
    pri = rng.permutation(n)
    both = cand_mask[src] & cand_mask[dst]
    s, d = src[both], dst[both]
    best = np.full(n, n + 1, np.int64)
    np.minimum.at(best, s, pri[d])
    np.minimum.at(best, d, pri[s])
    sel = cand_mask & (pri < best)
    return np.flatnonzero(sel)


def _cross_products(sel, in_ptr, in_src, in_w, in_assoc,
                    out_ptr, out_dst, out_w, out_assoc):
    """All (incoming u, outgoing w) pairs through each selected node —
    vectorized cross-product expansion."""
    p = (in_ptr[sel + 1] - in_ptr[sel]).astype(np.int64)
    q = (out_ptr[sel + 1] - out_ptr[sel]).astype(np.int64)
    total = p * q
    keep = total > 0
    sel, p, q, total = sel[keep], p[keep], q[keep], total[keep]
    if sel.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64), np.zeros(0, np.int64), 0
    starts = np.concatenate([[0], np.cumsum(total)[:-1]])
    k = np.arange(int(total.sum()), dtype=np.int64)
    vid = np.repeat(np.arange(sel.size), total)
    local = k - starts[vid]
    i_in = local // q[vid]
    i_out = local % q[vid]
    in_pos = in_ptr[sel][vid] + i_in
    out_pos = out_ptr[sel][vid] + i_out
    u = in_src[in_pos]
    wnode = out_dst[out_pos]
    length = in_w[in_pos] + out_w[out_pos]
    assoc = out_assoc[out_pos]
    ok = u != wnode
    return u[ok], wnode[ok], length[ok], assoc[ok], int(total.sum())


def build_hod_fast(g: Digraph, cfg: Optional[BuildConfig] = None,
                   device: Optional[BlockDevice] = None) -> BuildResult:
    cfg = cfg or BuildConfig()
    device = device or BlockDevice()
    rng = np.random.default_rng(cfg.seed)
    t0 = time.perf_counter()

    n = g.n
    src, dst, w = g.edge_list()
    assoc = src.copy()                       # §6: original edges carry src
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    device.sequential(src.size * TRIPLET_BYTES * 2)

    alive = np.ones(n, bool)
    rank = np.zeros(n, np.int64)
    removal_order: List[int] = []
    level_sizes: List[int] = []
    f_store: List[Tuple] = []                # per round: removed out-edges
    b_store: List[Tuple] = []
    stats = BuildStats()
    rounds = 0
    m_min_seen = src.size

    while rounds < cfg.max_rounds:
        m_alive = src.size
        n_alive = int(alive.sum())
        m_min_seen = min(m_min_seen, m_alive)
        if m_alive > cfg.fill_stop_ratio * max(m_min_seen, 1):
            break  # fill-in dominates: survivors become the core
        core_fits = (n_alive <= cfg.max_core_nodes
                     and m_alive <= cfg.max_core_edges)
        if n_alive == 0:
            break

        # CSR / CSC of the current reduced graph
        o_order = np.argsort(src, kind="stable")
        o_src, o_dst = src[o_order], dst[o_order]
        o_w, o_assoc = w[o_order], assoc[o_order]
        out_ptr = np.zeros(n + 1, np.int64)
        np.add.at(out_ptr, o_src + 1, 1)
        np.cumsum(out_ptr, out=out_ptr)
        i_order = np.argsort(dst, kind="stable")
        i_dst, i_src = dst[i_order], src[i_order]
        i_w, i_assoc = w[i_order], assoc[i_order]
        in_ptr = np.zeros(n + 1, np.int64)
        np.add.at(in_ptr, i_dst + 1, 1)
        np.cumsum(in_ptr, out=in_ptr)

        # ---- §4.2: scores ≤ ~median, Luby independent set --------------
        scores = _scores_vectorized(n, src, dst, alive)
        alive_ids = np.flatnonzero(alive)
        sample = (alive_ids if alive_ids.size <= cfg.median_sample else
                  rng.choice(alive_ids, cfg.median_sample, replace=False))
        thresh = np.median(scores[sample])
        cand_mask = alive & (scores <= thresh)
        selected = _luby_select(n, src, dst, cand_mask, rng)
        if selected.size == 0:
            break

        # ---- §4.1: candidate edges through each selected node ----------
        cu, cw, clen, cassoc, n_cands = _cross_products(
            selected, in_ptr, i_src, i_w, i_assoc,
            out_ptr, o_dst, o_w, o_assoc)
        stats.candidates_generated += n_cands
        # shortest candidate per (u, w)
        cu, cw, clen, cassoc = _dedup_min(cu, cw, clen, cassoc)

        # ---- §4.3: baseline edges --------------------------------------
        sel_mask = np.zeros(n, bool)
        sel_mask[selected] = True
        retained_edge = ~(sel_mask[src] | sel_mask[dst])
        bu = src[retained_edge]
        bw_ = dst[retained_edge]
        blen = w[retained_edge]
        n_base = min(cfg.baseline_factor * max(1, cu.size),
                     cfg.max_baseline_per_round)
        if n_base and m_alive:
            # degree-proportional mid sampling == random edge endpoint
            eidx = rng.integers(0, m_alive, n_base)
            pick_src = rng.random(n_base) < 0.5
            mids = np.where(pick_src, src[eidx], dst[eidx])
            ok = ~sel_mask[mids] & alive[mids]
            mids = mids[ok]
            p = (in_ptr[mids + 1] - in_ptr[mids])
            q = (out_ptr[mids + 1] - out_ptr[mids])
            ok2 = (p > 0) & (q > 0)
            mids, p, q = mids[ok2], p[ok2], q[ok2]
            if mids.size:
                ri = in_ptr[mids] + (rng.random(mids.size) * p).astype(
                    np.int64)
                ro = out_ptr[mids] + (rng.random(mids.size) * q).astype(
                    np.int64)
                uu, ww_ = i_src[ri], o_dst[ro]
                ll = i_w[ri] + o_w[ro]
                ok3 = (~sel_mask[uu]) & (~sel_mask[ww_]) & (uu != ww_)
                bu = np.concatenate([bu, uu[ok3]])
                bw_ = np.concatenate([bw_, ww_[ok3]])
                blen = np.concatenate([blen, ll[ok3]])
                stats.baselines_sampled += int(ok3.sum())

        # ---- §4.1 sort-merge: drop candidates beaten by a baseline -----
        device.external_sort(2 * (cu.size + bu.size) * TRIPLET_BYTES,
                             mem_bytes=64 << 20)
        if cu.size:
            all_u = np.concatenate([cu, bu])
            all_w = np.concatenate([cw, bw_])
            all_l = np.concatenate([clen, blen])
            is_cand = np.zeros(all_u.size, bool)
            is_cand[: cu.size] = True
            cand_row = np.full(all_u.size, -1, np.int64)
            cand_row[: cu.size] = np.arange(cu.size)
            order = np.lexsort((is_cand, all_l, all_w, all_u))
            su, sw = all_u[order], all_w[order]
            first = np.ones(su.size, bool)
            first[1:] = (su[1:] != su[:-1]) | (sw[1:] != sw[:-1])
            winner_cand = is_cand[order] & first
            keep_rows = cand_row[order][winner_cand]
            scu, scw = cu[keep_rows], cw[keep_rows]
            scl, sca = clen[keep_rows], cassoc[keep_rows]
        else:
            scu = scw = np.zeros(0, np.int64)
            scl = np.zeros(0, np.float64)
            sca = np.zeros(0, np.int64)
        stats.shortcuts_added += scu.size

        # ---- store removed nodes' adjacency (the F_f / F_b files) ------
        rm_out = sel_mask[o_src]
        rm_in = sel_mask[i_dst]
        f_store.append((o_src[rm_out], o_dst[rm_out], o_w[rm_out],
                        o_assoc[rm_out]))
        b_store.append((i_dst[rm_in], i_src[rm_in], i_w[rm_in],
                        i_assoc[rm_in]))
        stats.f_edges += int(rm_out.sum())
        stats.b_edges += int(rm_in.sum())
        device.sequential(int(rm_out.sum() + rm_in.sum()) * TRIPLET_BYTES)

        # ---- delete + install shortcuts ---------------------------------
        alive[selected] = False
        rank[selected] = rounds + 1
        removal_order.extend(np.sort(selected).tolist())
        level_sizes.append(int(selected.size))
        stats.removed += int(selected.size)

        keep_e = ~(sel_mask[src] | sel_mask[dst])
        src = np.concatenate([src[keep_e], scu])
        dst = np.concatenate([dst[keep_e], scw])
        w = np.concatenate([w[keep_e], scl])
        assoc = np.concatenate([assoc[keep_e], sca])
        src, dst, w, assoc = _dedup_min(src, dst, w, assoc)

        rounds += 1
        removed_frac = selected.size / n_alive
        if core_fits and removed_frac < cfg.min_shrink:
            break

    # ---- assemble BuildResult (same contract as the reference) ---------
    core_nodes = np.flatnonzero(alive).tolist()
    rank[alive] = rounds + 1
    core_edges = [(int(u), int(v), float(ww), int(a))
                  for u, v, ww, a in zip(src, dst, w, assoc)]

    f_adj: List = [None] * n
    b_adj: List = [None] * n
    for (fs, fd, fw, fa) in f_store:
        order = np.argsort(fs, kind="stable")
        fs, fd, fw, fa = fs[order], fd[order], fw[order], fa[order]
        bounds = np.flatnonzero(np.concatenate(
            [[True], fs[1:] != fs[:-1]])) if fs.size else []
        bounds = list(bounds) + [fs.size]
        for bi in range(len(bounds) - 1):
            lo, hi = bounds[bi], bounds[bi + 1]
            f_adj[fs[lo]] = [(int(fd[i]), float(fw[i]), int(fa[i]))
                             for i in range(lo, hi)]
    for (bs, bsrc, bw2, ba) in b_store:
        order = np.argsort(bs, kind="stable")
        bs, bsrc, bw2, ba = bs[order], bsrc[order], bw2[order], ba[order]
        bounds = np.flatnonzero(np.concatenate(
            [[True], bs[1:] != bs[:-1]])) if bs.size else []
        bounds = list(bounds) + [bs.size]
        for bi in range(len(bounds) - 1):
            lo, hi = bounds[bi], bounds[bi + 1]
            b_adj[bs[lo]] = [(int(bsrc[i]), float(bw2[i]), int(ba[i]))
                             for i in range(lo, hi)]
    for v in removal_order:
        if f_adj[v] is None:
            f_adj[v] = []
        if b_adj[v] is None:
            b_adj[v] = []

    stats.rounds = rounds
    stats.core_nodes = len(core_nodes)
    stats.core_edges = len(core_edges)
    stats.build_seconds = time.perf_counter() - t0
    stats.io = device.stats
    return BuildResult(n=n, rank=rank, removal_order=removal_order,
                       level_sizes=level_sizes, f_adj=f_adj, b_adj=b_adj,
                       core_nodes=core_nodes, core_edges=core_edges,
                       stats=stats)
