"""Wrapper of the split-K min-plus product (``csrc/tropical_matmul.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.  The split of K and
the copy widths are planned here, in plain Python the CPU tests reach.
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import load
from .ref import minplus_ref

__all__ = ["minplus", "plan_split_k", "copy_widths", "SplitK",
           "minplus_cost"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]

#: The kernel's block tile: BM rows x BN columns of out, K in tiles of BK.
BM, BN, BK = 32, 128, 32


def minplus_cost(m: int, k: int, n: int) -> "tuple[int, int]":
    """(bytes, operations) of ``[m, k] x [k, n]``: a, b read once and
    the f32 output written once; an add and a min a (row, column, k)."""
    return 4 * (m * k + k * n + m * n), 2 * m * k * n


class SplitK(NamedTuple):
    """A grid of ``blocks`` = column tiles x ``n_k`` chunks x row tiles,
    each chunk ``chunk`` deep (whole K tiles; the last may be shorter),
    run in ``waves`` waves of the resident blocks."""
    n_k: int
    chunk: int
    blocks: int
    waves: int


@functools.lru_cache(maxsize=256)
def plan_split_k(m: int, n: int, k: int, sms: int,
                 blocks_per_sm: int) -> SplitK:
    """Split K so the grid fills whole waves of resident blocks.

    Each candidate count of chunks, in whole K tiles with none empty, is
    costed as its makespan in K-tile times: waves x (tiles a chunk + 1,
    the pipeline's fill); the least wins, the fewer chunks on a tie (less
    scratch).  At [32, 15722] x [15722, 15722] on 132 SMs x 4 (the H100's
    resident blocks of the kernel): 17 chunks of 29 tiles (928), 2,091
    blocks in 4 waves of 528."""
    if min(m, n, k, sms, blocks_per_sm) < 1:
        raise ValueError(f"plan_split_k: needs positive sizes, got m={m} "
                         f"n={n} k={k} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm}")
    tiles = -(-n // BN) * -(-m // BM)
    k_tiles = -(-k // BK)
    slots = sms * blocks_per_sm
    best = None
    for want in range(1, k_tiles + 1):
        per = -(-k_tiles // want)           # K tiles a chunk
        n_k = -(-k_tiles // per)            # no empty chunk
        if n_k != want:
            continue
        blocks = tiles * n_k
        waves = -(-blocks // slots)
        cost = waves * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, SplitK(n_k, per * BK, blocks, waves))
    return best[1]


def copy_widths(n: int, k: int, lda: int, a_ptr: int,
                b_ptr: int) -> "tuple[int, int]":
    """The widest cp.async copies (16, 8 or 4 bytes) each operand allows:
    a chunk of ``a`` must be aligned and never straddle K (so a row's
    elements a chunk holds divide ``lda``, ``k`` and the base), a chunk
    of ``b`` the same with ``n``."""
    def widest(*sizes_in_floats, ptr):
        for v in (16, 8, 4):
            if ptr % v == 0 and all(s % (v // 4) == 0
                                    for s in sizes_in_floats):
                return v
        raise ValueError("minplus: operands must be 4-byte aligned")
    return widest(lda, k, ptr=a_ptr), widest(n, ptr=b_ptr)


@functools.lru_cache(maxsize=None)
def _device_config(index: int) -> "tuple[int, int, int]":
    """(SMs, resident blocks a SM, dynamic shared memory a block) of the
    split pass on CUDA device ``index``, asked once."""
    with torch.cuda.device(index):
        buf = (ctypes.c_int * 2)()
        err = load("tropical_matmul").tropical_minplus_config(buf)
        if err:
            raise RuntimeError(f"tropical_matmul: occupancy query failed: "
                               f"CUDA error {err}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, buf[0], buf[1]


def device_config(device: torch.device) -> "tuple[int, int, int]":
    """(SMs, resident blocks a SM, shared memory bytes a block)."""
    index = torch.device(device).index
    return _device_config(torch.cuda.current_device() if index is None
                          else index)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"minplus: a and b must share one CPU or CUDA "
                         f"device, got {a.device} and {b.device}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"minplus: {name} must be 2-d float32, got "
                             f"{t.dim()}-d {t.dtype}")
    # a may be a column slice of a wider matrix (the core block of the
    # label state); its rows must still be contiguous.
    if a.stride(1) != 1 or (a.shape[0] > 1 and a.stride(0) < a.shape[1]):
        raise ValueError("minplus: a's rows must be contiguous")
    if not b.is_contiguous():
        raise ValueError("minplus: b must be contiguous")


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = min_k a[i, k] + b[k, j]`` (f32), as a new tensor.
    ``minplus.launches`` counts kernel launches."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"minplus: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not form a product")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return minplus_ref(a, b)
    return _launch(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor, n_k: int = None) -> torch.Tensor:
    """The kernel on CUDA tensors, K cut as :func:`plan_split_k` plans;
    ``n_k`` forces another number of chunks (for the card tests of the
    splits' edges)."""
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.fill_(float("inf"))
    sms, per_sm, _ = device_config(a.device)
    plan = plan_split_k(m, n, k, sms, per_sm)
    if n_k is not None:
        k_tiles = -(-k // BK)
        per = -(-k_tiles // n_k)
        plan = SplitK(-(-k_tiles // per), per * BK, 0, 0)
    lda = a.stride(0) if m > 1 else k
    va, vb = copy_widths(n, k, lda, a.data_ptr(), b.data_ptr())
    part = (torch.empty(plan.n_k * m * n, dtype=torch.float32,
                        device=a.device) if plan.n_k > 1 else out)
    fn = load("tropical_matmul").tropical_minplus
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(),
             m, n, k, lda, plan.n_k, plan.chunk, va, vb,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"tropical_matmul launch failed: CUDA error {err}")
    minplus.launches += 1
    return out


minplus.launches = 0
