"""The comparison that decides ``correct``.

Served answer rows are held to the reference's distances entry by entry,
and SSSP predecessors to the shortest-path-tree property on the
reference's distances.  Every distance of both configurations is an
integer below 2**24, so float32 holds it exactly and each number below
has the limit 0 (an exact comparison); see ``PERF.md`` for the readings
each limit was set from.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .reference import ArcTable, shortest_distances

__all__ = ["LIMITS", "dist_errors", "pred_errors", "check_rows",
           "check_answers", "judge"]

#: The limit of each number compared (the run passes while each number
#: is at most its limit), and for ``rows_checked`` the least it may be.
LIMITS = {"wrong_dist": 0, "max_dist_err": 0.0, "bad_pred": 0,
          "failed": 0}


def dist_errors(ref: np.ndarray, got: np.ndarray) -> Dict[str, float]:
    """Entries of ``got`` (``[K, n]``) that differ from ``ref``, and the
    widest gap between the two (``inf`` where one side is unreachable
    and the other not)."""
    got = np.asarray(got, np.float64)
    same = got == ref                   # inf == inf: both unreachable
    with np.errstate(invalid="ignore"):
        gap = np.where(same, 0.0, np.abs(got - ref))
    gap = np.where(np.isnan(gap), np.inf, gap)
    return {"wrong_dist": int((~same).sum()),
            "max_dist_err": float(gap.max()) if gap.size else 0.0}


def pred_errors(ref: np.ndarray, pred: np.ndarray, sources: np.ndarray,
                arcs: ArcTable) -> int:
    """Nodes whose predecessor breaks the shortest-path tree: a source or
    an unreachable node must have ``-1``; any other node ``v`` a
    predecessor ``u`` with an arc ``u -> v`` and ``ref[u] + w = ref[v]``
    (weights are positive, so such steps cannot close a cycle)."""
    pred = np.asarray(pred, np.int64)
    k, n = pred.shape
    cols = np.broadcast_to(np.arange(n), (k, n))
    root = cols == np.asarray(sources, np.int64)[:, None]
    none = root | ~np.isfinite(ref)
    bad = int((none & (pred != -1)).sum())
    need = ~none
    u, v = pred[need], cols[need]
    rows = np.broadcast_to(np.arange(k)[:, None], (k, n))[need]
    ok = (u >= 0) & (u < n)
    w = np.full(u.shape, np.nan)
    w[ok] = arcs.weight(u[ok], v[ok])
    ok &= ~np.isnan(w)
    ok[ok] = ref[rows[ok], u[ok]] + w[ok] == ref[rows[ok], v[ok]]
    return bad + int((~ok).sum())


def judge(numbers: Dict[str, float], rows_wanted: int
          ) -> "tuple[bool, Dict[str, dict]]":
    """``(correct, checks)``: each number beside its limit.  A run that
    checked fewer rows than it kept is not correct."""
    checks = {name: {"value": value, "limit": LIMITS[name]}
              for name, value in numbers.items() if name in LIMITS}
    checks["rows_checked"] = {"value": numbers.get("rows_checked", 0),
                              "least": rows_wanted}
    ok = all(c["value"] <= c["limit"] for name, c in checks.items()
             if name != "rows_checked")
    ok &= checks["rows_checked"]["value"] >= max(rows_wanted, 1)
    return bool(ok), checks


def check_rows(ref: np.ndarray, dist: np.ndarray, sources: np.ndarray,
               pred: Optional[np.ndarray] = None,
               arcs: Optional[ArcTable] = None) -> Dict[str, float]:
    """Every number compared for a block of served rows."""
    out = dist_errors(ref, dist)
    if pred is not None:
        out["bad_pred"] = pred_errors(ref, pred, sources, arcs)
    out["rows_checked"] = int(dist.shape[0])
    return out


def check_answers(kept, mode: str, n: int, src: np.ndarray, dst: np.ndarray,
                  w: np.ndarray, device) -> Dict[str, float]:
    """The numbers compared for a run's sample of ``(source, answer)``
    pairs (answers with ``dist``, and ``pred`` in SSSP), against the
    reference worked out on ``device`` from the arc lists."""
    numbers = {"wrong_dist": 0, "max_dist_err": 0.0, "rows_checked": 0}
    if mode == "sssp":
        numbers["bad_pred"] = 0
    if not kept:
        return numbers
    rows = np.asarray([s for s, _ in kept], np.int64)
    uniq, inv = np.unique(rows, return_inverse=True)
    ref = shortest_distances(n, src, dst, w, uniq, device=device)[inv]
    dist = np.stack([a.dist for _, a in kept])
    if mode == "sssp":
        pred = np.stack([a.pred for _, a in kept])
        return check_rows(ref, dist, rows, pred, ArcTable(n, src, dst, w))
    return check_rows(ref, dist, rows)
