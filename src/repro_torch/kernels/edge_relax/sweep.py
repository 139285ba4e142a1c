"""A sweep's plan levels packed for ``relax_sweep_``: compacted CSR rows.

A bucketed plan level (``dst [M]``, ``src_idx [M, K]``, ``w [M, K]``,
``row_valid [M]``) pads every row to K slots and splits a long in-edge
list over several rows of one destination.  :func:`pack_sweep` keeps
only what relaxes: the slots of finite weight in valid rows, merged into
one row per distinct destination (min is exact in any order, so merging
changes no result), rows in ascending destination order, levels
concatenated behind a level pointer.  Plain numpy; the result lives on
one device.
"""
from typing import Iterable, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["Sweep", "pack_sweep", "ways_of", "SLOTS_A_THREAD"]

# The most slots of one row that one kernel thread walks, where a row can
# be split (caps of 4 and 2 measured slower on the served sweeps).
SLOTS_A_THREAD = 8
# Threads a row the kernel may use: 2**j for j < LANE_FORMS.
LANE_FORMS = 6


def ways_of(longest: int, lanes: int) -> int:
    """Thread groups that split each row of a level whose longest row has
    ``longest`` slots, at ``lanes`` threads a row: enough that none walks
    more than ``SLOTS_A_THREAD`` of them, a power of two, and ``lanes x
    ways`` within one warp.  The only copy of this rule: the kernel reads
    it from :attr:`Sweep.ways`, the launch plan sizes the grid by it."""
    k = 1
    while k * SLOTS_A_THREAD < longest and k * lanes < 32:
        k *= 2
    return k


class Sweep(NamedTuple):
    """Levels ``0 .. n_levels-1`` of a sweep: level ``l`` is rows
    ``levels[l] .. levels[l+1]``, row ``r`` writes node ``row_dst[r]``
    from the slots ``row_ptr[r] .. row_ptr[r+1]`` (``src``, ``w``), and
    no row of level ``l`` has more than ``level_max_slots[l]`` slots.
    ``level_rows`` and ``level_slots`` are ``levels`` and
    ``row_ptr[levels]`` on the host; ``ways[j, l]`` is
    ``ways_of(level_max_slots[l], 2**j)``.  ``n_nodes`` bounds every
    index."""
    levels: torch.Tensor      # int32 [L + 1]
    ways: torch.Tensor        # int32 [LANE_FORMS, L]
    row_dst: torch.Tensor     # int32 [R]
    row_ptr: torch.Tensor     # int32 [R + 1]
    src: torch.Tensor         # int32 [E]
    w: torch.Tensor           # float32 [E], finite
    level_rows: Tuple[int, ...]
    level_slots: Tuple[int, ...]
    level_max_slots: Tuple[int, ...]
    n_nodes: int

    @property
    def n_levels(self) -> int:
        return len(self.level_rows) - 1

    @property
    def level_widths(self) -> Tuple[int, ...]:
        """Rows of each level."""
        r = self.level_rows
        return tuple(b - a for a, b in zip(r, r[1:]))

    def level(self, i: int) -> "Sweep":
        """Level ``i`` alone, as a one-level sweep over the same
        tensors (its level pointer and ways are views)."""
        if not 0 <= i < self.n_levels:
            raise IndexError(f"level {i} of a {self.n_levels}-level sweep")
        return self._replace(levels=self.levels[i:i + 2],
                             ways=self.ways[:, i:i + 1],
                             level_rows=self.level_rows[i:i + 2],
                             level_slots=self.level_slots[i:i + 2],
                             level_max_slots=self.level_max_slots[i:i + 1])


def pack_sweep(levels: Iterable[Tuple[np.ndarray, ...]], n_nodes: int,
               device=None) -> Sweep:
    """Pack bucketed levels ``(dst [M], src_idx [M, K], w [M, K],
    row_valid [M])``, in sweep order, into one :class:`Sweep` on
    ``device``.  Raises if an index of a kept slot lies outside
    ``[0, n_nodes)`` or a level reads a node that another of its rows
    writes (the kernel updates ``dist`` in place, unsynchronised within
    a level)."""
    level_ptr, slot_ptr, max_slots = [0], [0], []
    dsts, row_ends, srcs, ws = [], [np.zeros(1, np.int64)], [], []
    for i, (dst, src_idx, w, valid) in enumerate(levels):
        dst, src_idx, w = (np.asarray(a) for a in (dst, src_idx, w))
        keep = np.asarray(valid, bool)[:, None] & np.isfinite(w)
        r, k = np.nonzero(keep)
        d, s, wk = dst[r], src_idx[r, k], w[r, k]
        order = np.argsort(d, kind="stable")
        d, s, wk = d[order], s[order], wk[order]
        uniq, counts = np.unique(d, return_counts=True)
        for name, idx in (("dst", uniq), ("src", s)):
            if idx.size and (idx.min() < 0 or idx.max() >= n_nodes):
                raise ValueError(f"pack_sweep: level {i} has a {name} "
                                 f"index outside [0, {n_nodes})")
        if np.isin(s[s != d], uniq).any():
            raise ValueError(f"pack_sweep: level {i} reads a node that "
                             "it writes")
        dsts.append(uniq)
        row_ends.append(slot_ptr[-1] + np.cumsum(counts))
        srcs.append(s)
        ws.append(wk)
        max_slots.append(int(counts.max(initial=0)))
        level_ptr.append(level_ptr[-1] + uniq.size)
        slot_ptr.append(slot_ptr[-1] + s.size)
    if slot_ptr[-1] >= 2 ** 31:
        raise ValueError("pack_sweep: int32 row pointers address at most "
                         "2**31 - 1 slots")

    def to(parts, dtype):
        arr = np.concatenate(parts) if parts else np.zeros(0)
        return torch.from_numpy(arr.astype(dtype)).to(device)

    ways = np.array([[ways_of(m, 1 << j) for m in max_slots]
                     for j in range(LANE_FORMS)], np.int32)
    return Sweep(levels=to([np.asarray(level_ptr)], np.int32),
                 ways=torch.from_numpy(ways).to(device),
                 row_dst=to(dsts, np.int32), row_ptr=to(row_ends, np.int32),
                 src=to(srcs, np.int32), w=to(ws, np.float32),
                 level_rows=tuple(level_ptr), level_slots=tuple(slot_ptr),
                 level_max_slots=tuple(max_slots), n_nodes=int(n_nodes))
