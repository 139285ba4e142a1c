"""Wrapper of the tiled min-plus product (``csrc/tropical_matmul.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.
"""
import ctypes

import torch

from .._build import load
from .ref import minplus_ref

__all__ = ["minplus"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong, ctypes.c_void_p]


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
    _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = load("tropical_matmul").tropical_minplus
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
             a.stride(0), torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"tropical_matmul launch failed: CUDA error {err}")
    minplus.launches += 1
    return out


minplus.launches = 0
