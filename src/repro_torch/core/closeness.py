"""Closeness-centrality estimation (the paper's flagship application).

Eppstein–Wang [11]: sample ``k = ln n / eps^2`` source nodes, run an SSD
query from each, and estimate every node's *farness* as
``n / (k (n-1)) * sum_i dist(s_i, v)`` (inverted for closeness).  Table 5
of the paper scores methods by total wall time = preprocessing + k queries;
HoD's batched engine answers the k queries in a handful of batched sweeps.

The JAX package's ``core/closeness.py`` over the port's engines.  The
engines return host numpy rows (``QueryEngine.ssd``), and the farness
sums run on those host arrays with numpy, in the reference's order: a
sum in another order can round otherwise and change a ranking or a
prune.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from .query import QueryEngine

__all__ = ["ClosenessResult", "TopKCloseness", "estimate_closeness",
           "topk_closeness"]


@dataclasses.dataclass
class ClosenessResult:
    closeness: np.ndarray      # [n] estimated closeness per node
    k: int                     # number of sampled sources
    query_seconds: float
    batches: int


def estimate_closeness(engine: QueryEngine, eps: float = 0.1,
                       batch_size: int = 64, seed: int = 0,
                       k_override: Optional[int] = None) -> ClosenessResult:
    """Eppstein–Wang closeness of every node from ``k`` sampled sources,
    run through ``engine`` in fixed-size batches (a short last batch is
    padded by repeating its last source)."""
    n = engine.index.n
    k = k_override if k_override is not None else max(
        1, int(math.ceil(math.log(max(n, 2)) / (eps * eps))))
    rng = np.random.default_rng(seed)
    sources = rng.choice(n, size=min(k, n), replace=False).astype(np.int32)
    k = sources.shape[0]

    t0 = time.perf_counter()
    farness_sum = np.zeros(n, dtype=np.float64)
    batches = 0
    for lo in range(0, k, batch_size):
        batch = sources[lo:lo + batch_size]
        if batch.shape[0] < batch_size:  # keep one batch shape
            batch = np.pad(batch, (0, batch_size - batch.shape[0]),
                           mode="edge")
        d = engine.ssd(batch)[:len(sources[lo:lo + batch_size]), :n]
        d = np.where(np.isfinite(d), d, 0.0)  # WCC assumption (paper §7.1)
        farness_sum += d.sum(axis=0)
        batches += 1
    dt = time.perf_counter() - t0

    denom = farness_sum * (n / (k * max(n - 1, 1)))
    with np.errstate(divide="ignore"):
        closeness = np.where(denom > 0, 1.0 / denom, 0.0)
    return ClosenessResult(closeness=closeness, k=k, query_seconds=dt,
                           batches=batches)


@dataclasses.dataclass
class TopKCloseness:
    """The ``k`` most-central candidates by *exact* (out-)closeness."""

    nodes: np.ndarray          # [k] node ids, best first
    closeness: np.ndarray      # [k] (n-1) / farness per node
    farness: np.ndarray        # [k] sum of finite out-distances
    k: int
    query_seconds: float
    batches: int
    pruned: int                # candidates abandoned mid-sweep (bounded
    #                            engines only; 0 for full-sweep engines)


def topk_closeness(engine: QueryEngine, k: int,
                   candidates: Optional[np.ndarray] = None,
                   batch_size: int = 32, seed: int = 0) -> TopKCloseness:
    """Exact top-``k`` closeness over a candidate set (DESIGN.md §7).

    Each candidate's *farness* is the sum of its finite out-distances
    (the same WCC convention as :func:`estimate_closeness` — unreachable
    nodes contribute 0); closeness is ``(n-1) / farness`` and top-k
    means the ``k`` smallest farness values, node id breaking ties.

    Candidates run through the engine in fixed-shape batches.  When the
    engine has ``ssd_bounded`` (the store-backed
    :class:`~repro_torch.storage.StreamingQueryEngine`), each batch's
    sweep carries the current k-th best farness as an abandon
    threshold: the backward sweep finalizes nodes level by level, so a
    batch whose every row's partial farness already exceeds the
    threshold stops reading plan levels — real I/O saved, the same
    answers (a partial sum of nonnegative distances is a lower bound on
    the total).  Candidates are visited in a seeded random order so
    early batches seed a tight threshold however the candidate list was
    sorted.
    """
    n = engine.index.n
    cand = (np.arange(n, dtype=np.int32) if candidates is None
            else np.asarray(candidates, dtype=np.int32))
    if not 1 <= k <= cand.shape[0]:
        raise ValueError(f"k={k} out of range for {cand.shape[0]} "
                         "candidates")
    order = np.random.default_rng(seed).permutation(cand.shape[0])
    cand = cand[order]
    bounded = getattr(engine, "ssd_bounded", None)

    t0 = time.perf_counter()
    completed: list = []       # (farness, node) for fully-swept candidates
    threshold = math.inf       # current k-th best farness
    batches = pruned = 0
    for lo in range(0, cand.shape[0], batch_size):
        batch = cand[lo:lo + batch_size]
        real = batch.shape[0]
        if real < batch_size:  # keep one batch shape
            batch = np.pad(batch, (0, batch_size - real), mode="edge")
        if bounded is not None and math.isfinite(threshold):
            dist, done = bounded(batch, threshold)
        else:
            dist, done = engine.ssd(batch), True
        batches += 1
        if not done:
            pruned += real
            continue
        d = dist[:real, :n]
        far = np.where(np.isfinite(d), d, 0.0).sum(axis=1)
        completed.extend(zip(far.tolist(), batch[:real].tolist()))
        completed.sort()
        if len(completed) >= k:
            threshold = completed[k - 1][0]
    dt = time.perf_counter() - t0

    top = completed[:k]
    far = np.array([f for f, _ in top])
    with np.errstate(divide="ignore"):
        clo = np.where(far > 0, (n - 1) / far, 0.0)
    return TopKCloseness(
        nodes=np.array([v for _, v in top], dtype=np.int32),
        closeness=clo, farness=far, k=k, query_seconds=dt,
        batches=batches, pruned=pruned)
