"""A sweep's plan levels packed for ``relax_sweep_``: compacted CSR rows.

A bucketed plan level (``dst [M]``, ``src_idx [M, K]``, ``w [M, K]``,
``row_valid [M]``) pads every row to K slots and splits a long in-edge
list over several rows of one destination.  :func:`pack_sweep` keeps
only what relaxes: the slots of finite weight in valid rows, merged into
one row per distinct destination (min is exact in any order, so merging
changes no result), rows in ascending destination order, levels
concatenated behind a level pointer.  Plain numpy; the result lives on
one device.

A store-backed engine streams a sweep one level at a time:
:func:`pack_level` packs each level by the same rule and moves it to
the card through a :class:`PinnedStager`'s two pinned buffers.
"""
import time
from typing import Iterable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Sweep", "pack_sweep", "pack_level", "PinnedStager", "ways_of",
           "SLOTS_A_THREAD"]

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


def _pack_host(levels: Iterable[Tuple[np.ndarray, ...]], n_nodes: int
               ) -> Tuple[Tuple[np.ndarray, ...], Tuple[Tuple[int, ...], ...]]:
    """:func:`pack_sweep` on the host: the six arrays of a
    :class:`Sweep` (``levels``, ``ways``, ``row_dst``, ``row_ptr``,
    ``src``, ``w``) as numpy, and its host tuples (``level_rows``,
    ``level_slots``, ``level_max_slots``), in the order of its fields."""
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

    def cat(parts, dtype):
        arr = np.concatenate(parts) if parts else np.zeros(0)
        return arr.astype(dtype)

    ways = np.array([[ways_of(m, 1 << j) for m in max_slots]
                     for j in range(LANE_FORMS)], np.int32)
    arrays = (np.asarray(level_ptr, np.int32),
              ways.reshape(LANE_FORMS, len(max_slots)),
              cat(dsts, np.int32), cat(row_ends, np.int32),
              cat(srcs, np.int32), cat(ws, np.float32))
    return arrays, (tuple(level_ptr), tuple(slot_ptr), tuple(max_slots))


def pack_sweep(levels: Iterable[Tuple[np.ndarray, ...]], n_nodes: int,
               device=None) -> Sweep:
    """Pack bucketed levels ``(dst [M], src_idx [M, K], w [M, K],
    row_valid [M])``, in sweep order, into one :class:`Sweep` on
    ``device``.  Raises if an index of a kept slot lies outside
    ``[0, n_nodes)`` or a level reads a node that another of its rows
    writes (the kernel updates ``dist`` in place, unsynchronised within
    a level)."""
    arrays, host = _pack_host(levels, n_nodes)
    return Sweep(*(torch.from_numpy(a).to(device) for a in arrays), *host,
                 int(n_nodes))


def pack_level(level: Tuple[np.ndarray, ...], n_nodes: int,
               stager: "PinnedStager") -> Sweep:
    """One streamed level ``(dst, src_idx, w, row_valid)`` packed as a
    one-level :class:`Sweep` by :func:`pack_sweep`'s rule (and its
    checks), its six arrays moved to the stager's device in one copy."""
    arrays, host = _pack_host([level], n_nodes)
    return Sweep(*stager.stage(arrays), *host, int(n_nodes))


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.bool_): torch.bool,
                 np.dtype(np.uint8): torch.uint8}


class PinnedStager:
    """Moves a streamed level's host arrays to ``device`` in one copy.

    The arrays are written, each at a 16-byte aligned offset, into one
    pinned host buffer, which goes to the card by one ``non_blocking``
    copy on the current stream; the level's tensors are views of the
    copy.  Two pinned buffers take turns, so packing level ``i + 1``
    overlaps level ``i``'s copy, and a buffer is written again only
    after the CUDA event recorded behind its last copy has completed (a
    buffer refilled while its copy is in flight would hand the card a
    mix of two levels).  On the CPU the views are of a fresh buffer.

    ``copies``, ``bytes`` and ``peak_bytes`` (the largest single copy)
    count what went to the device; ``stage_s`` is the host's time in
    :meth:`stage` and ``wait_s`` the part of it spent waiting for a
    buffer's previous copy.
    """

    ALIGN = 16

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs = [None, None]
        self._events = [None, None]
        self._turn = 0
        self.copies = 0
        self.bytes = 0
        self.peak_bytes = 0
        self.stage_s = 0.0
        self.wait_s = 0.0

    def _host_buffer(self, nbytes: int) -> Tuple[torch.Tensor, int]:
        """The next buffer in turn, at least ``nbytes`` long, once its
        previous copy has completed."""
        i, self._turn = self._turn, self._turn ^ 1
        if self._events[i] is not None:
            t0 = time.perf_counter()
            self._events[i].synchronize()
            self.wait_s += time.perf_counter() - t0
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 2 * (0 if buf is None else buf.numel()))
            buf = self._bufs[i] = torch.empty(size, dtype=torch.uint8,
                                              pin_memory=True)
        return buf, i

    def stage(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """``arrays`` on the device, as views of one copy."""
        t0 = time.perf_counter()
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offsets, end = [], 0
        for a in arrays:
            offsets.append(end)
            end += -(-a.nbytes // self.ALIGN) * self.ALIGN
        cuda = self.device.type == "cuda"
        if cuda:
            buf, turn = self._host_buffer(end)
        else:
            buf = torch.empty(end, dtype=torch.uint8)
        host = buf.numpy()
        for a, off in zip(arrays, offsets):
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        if cuda:
            dev = buf[:end].to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[turn] = ev
        else:
            dev = buf
        self.copies += 1
        self.bytes += end
        self.peak_bytes = max(self.peak_bytes, end)
        self.stage_s += time.perf_counter() - t0
        return [dev[off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype])
                .reshape(a.shape) for a, off in zip(arrays, offsets)]
