"""Wrapper of the one-launch sweep relaxation (``csrc/edge_relax.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.  The launch's shape
is planned here, in plain Python the CPU tests reach.
"""
import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from .._build import load
from .ref import relax_sweep_ref_
from .sweep import Sweep, ways_of

__all__ = ["relax_sweep_", "plan_sweep_launch", "SweepLaunch",
           "relax_sweep_cost"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def relax_sweep_cost(n_levels: int, rows: int, slots: int, read: int,
                     written: int, s: int) -> "tuple[int, int]":
    """(bytes, operations) of one sweep over S sources, all its state in
    L2: its CSR once (the level pointers and ways, a row's destination
    and pointer, a slot's source and weight, 4 bytes each), the S labels
    of each of the ``read`` distinct nodes it reads (a source, or a
    destination's old labels) read once, and those of the ``written``
    distinct nodes it writes written once; an add and a min a slot and
    source."""
    csr = 4 * (2 * n_levels + 1) + 8 * rows + 4 + 8 * slots
    return csr + 4 * s * (read + written), 2 * s * slots


class SweepLaunch(NamedTuple):
    """``vec`` labels a load (4: 16 bytes, or 1); ``lanes`` threads
    cover a row's labels, and at level ``l`` ``ways[l]`` groups of them
    split its slots (``lanes x ways`` a power of two, at most 32); a
    cooperative grid of ``blocks``."""
    vec: int
    lanes: int
    ways: Tuple[int, ...]
    blocks: int


def plan_sweep_launch(n_cols: int, aligned: bool, level_rows: Sequence[int],
                      level_max_slots: Sequence[int], threads: int,
                      resident: int) -> SweepLaunch:
    """16-byte loads when a node's ``n_cols`` labels split into them
    (and ``dist`` is 16-byte ``aligned``); as many lanes a row as it has
    loads, rounded up to a power of two and capped at a warp; at each
    level, :func:`~.sweep.ways_of` its longest row (the kernel reads the
    same from ``Sweep.ways``); and no more blocks than the widest level
    fills, nor than are ``resident`` at once (a cooperative grid must
    be).  At S = 32: 8 lanes a row, and 64 rows a block of 512 threads
    where a level's rows are short."""
    if min(n_cols, threads, resident, len(level_rows)) < 1 \
            or len(level_rows) != len(level_max_slots):
        raise ValueError(f"plan_sweep_launch: needs positive sizes, got "
                         f"n_cols={n_cols} levels={len(level_rows)} "
                         f"max_slots={len(level_max_slots)} "
                         f"threads={threads} resident={resident}")
    vec = 4 if aligned and n_cols % 4 == 0 else 1
    lanes = min(32, 1 << (n_cols // vec - 1).bit_length())
    ways = tuple(ways_of(longest, lanes) for longest in level_max_slots)
    need = max(rows * lanes * k for rows, k in zip(level_rows, ways))
    blocks = min(resident, max(1, -(-need // threads)))
    return SweepLaunch(vec, lanes, ways, blocks)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, built if needed, with its argument types
    set once."""
    lib = load("edge_relax")
    lib.edge_relax_sweep.argtypes = _ARGTYPES
    lib.edge_relax_sweep.restype = ctypes.c_int
    lib.edge_relax_config.argtypes = [ctypes.c_void_p]
    lib.edge_relax_config.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _device_config(index: int) -> "tuple[int, int, int]":
    """(SMs, threads a block, resident blocks an SM of either form) on
    CUDA device ``index``, asked once."""
    with torch.cuda.device(index):
        buf = (ctypes.c_int * 2)()
        err = _lib().edge_relax_config(buf)
        if err:
            raise RuntimeError(f"edge_relax: occupancy query failed: "
                               f"CUDA error {err}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, buf[0], buf[1]


def device_config(device: torch.device) -> "tuple[int, int, int]":
    """(SMs, threads a block, resident blocks an SM)."""
    index = torch.device(device).index
    return _device_config(torch.cuda.current_device() if index is None
                          else index)


def _check(dist: torch.Tensor, sweep: Sweep) -> None:
    if dist.device.type != "cuda":
        raise ValueError(f"relax_sweep_: dist must be on the CPU or a CUDA "
                         f"device, got {dist.device}")
    if dist.dtype != torch.float32 or dist.dim() != 2 \
            or not dist.is_contiguous():
        raise ValueError(f"relax_sweep_: dist must be a contiguous 2-d "
                         f"float32 [N, S], got {dist.dim()}-d {dist.dtype}")
    if dist.shape[0] < sweep.n_nodes:
        raise ValueError(f"relax_sweep_: dist has {dist.shape[0]} nodes, "
                         f"the sweep indexes {sweep.n_nodes}")
    if sweep.src.device != dist.device:
        raise ValueError(f"relax_sweep_: the sweep is on "
                         f"{sweep.src.device}, dist on {dist.device}")


def relax_sweep_(dist: torch.Tensor, sweep: Sweep) -> torch.Tensor:
    """Relax every level of ``sweep`` into ``dist`` in place, in order,
    and return it:

        for each level, for each row r and each source s:
            dist[row_dst[r], s] = min(dist[row_dst[r], s],
                                      min over r's slots e of
                                      dist[src[e], s] + w[e])

    ``dist`` is node-major, [N, S] f32 contiguous; ``sweep`` comes from
    :func:`~repro_torch.kernels.edge_relax.sweep.pack_sweep` (one level:
    ``sweep.level(i)``).  One launch a sweep; a sweep without slots
    launches nothing.  ``relax_sweep_.launches`` counts kernel launches.
    """
    if dist.device.type == "cpu":
        return relax_sweep_ref_(dist, sweep)
    _check(dist, sweep)
    n_cols = dist.shape[1]
    if n_cols == 0 or sweep.level_slots[0] == sweep.level_slots[-1]:
        return dist
    sms, threads, per_sm = device_config(dist.device)
    plan = plan_sweep_launch(n_cols, dist.data_ptr() % 16 == 0,
                             sweep.level_widths, sweep.level_max_slots,
                             threads, sms * per_sm)
    ways = sweep.ways[plan.lanes.bit_length() - 1]   # plan.ways, on device
    err = _lib().edge_relax_sweep(
        dist.data_ptr(), sweep.levels.data_ptr(), ways.data_ptr(),
        sweep.n_levels, sweep.row_dst.data_ptr(), sweep.row_ptr.data_ptr(),
        sweep.src.data_ptr(), sweep.w.data_ptr(), n_cols, plan.vec,
        plan.lanes, plan.blocks,
        torch.cuda.current_stream(dist.device).cuda_stream)
    if err:
        raise RuntimeError(f"edge_relax launch failed: CUDA error {err}")
    relax_sweep_.launches += 1
    return dist


relax_sweep_.launches = 0
