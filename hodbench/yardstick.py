"""The ruler: the card's peaks and the bytes and operations a kernel's
work needs, counted from the work itself and not from how the program
lays it out, so that a later change to a kernel's layout leaves the
count alone.

A kernel's bound is the larger of its bytes over the card's memory
bandwidth and its operations over its SIMT rate (an add and a min are
one operation each; Hopper has no fused float add-min).  Its share of
the roofline is bound / measured device time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["PEAK", "bound_s", "minplus_cost", "sweep_cost"]

#: NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes a second, and 32-bit
#: SIMT operations a second: 132 SMs x 128 lanes x 1.98 GHz.
PEAK = {"hbm_bytes_per_s": 3.35e12,
        "simt_ops_per_s": 132 * 128 * 1.98e9}


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for the work, in seconds."""
    return max(nbytes / PEAK["hbm_bytes_per_s"], ops / PEAK["simt_ops_per_s"])


def minplus_cost(s: int, c: int) -> Tuple[int, int]:
    """(bytes, operations) of the core search's ``[S, C] x [C, C]``
    min-plus product: each operand read once, the f32 result written
    once; an add and a min a (row, column, k)."""
    return 4 * (s * c + c * c + s * c), 2 * s * c * c


def sweep_cost(plan, s: int) -> Tuple[int, int]:
    """(bytes, operations) of one relaxation sweep over S sources, from
    the plan's real arcs (its finite slots of valid rows in real levels):
    each arc's two ids and weight read once (12 bytes), the S labels of
    each distinct node the sweep touches read once, those of each
    distinct destination written once (f32); an add and a min an arc and
    source."""
    live = (np.asarray(plan.level_mask)[:, None, None]
            & np.asarray(plan.row_valid)[:, :, None]
            & np.isfinite(np.asarray(plan.w)))
    arcs = int(live.sum())
    src = np.asarray(plan.src_idx)[live]
    dst = np.broadcast_to(np.asarray(plan.dst)[:, :, None], live.shape)[live]
    read = np.union1d(src, dst).size
    written = np.unique(dst).size
    return 12 * arcs + 4 * s * (read + written), 2 * s * arcs
