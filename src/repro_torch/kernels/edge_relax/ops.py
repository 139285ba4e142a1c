"""Wrapper of the fused in-place level relaxation (``csrc/edge_relax.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.
"""
import ctypes

import torch

from .._build import load
from .ref import relax_level_ref_

__all__ = ["relax_level_"]

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong, ctypes.c_void_p]


def _check(dist, dst, src_idx, w, row_valid) -> None:
    dev = dist.device
    if dev.type != "cuda":
        raise ValueError(f"relax_level_: dist must be on the CPU or a CUDA "
                         f"device, got {dev}")
    for name, t, dtype, ndim in (("dist", dist, torch.float32, 2),
                                 ("dst", dst, torch.int32, 1),
                                 ("src_idx", src_idx, torch.int32, 2),
                                 ("w", w, torch.float32, 2),
                                 ("row_valid", row_valid, torch.bool, 1)):
        if t.device != dev:
            raise ValueError(f"relax_level_: {name} is on {t.device}, "
                             f"dist on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"relax_level_: {name} must be {ndim}-d "
                             f"{dtype}, got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"relax_level_: {name} must be contiguous")
    m = dst.shape[0]
    if src_idx.shape[0] != m or w.shape != src_idx.shape \
            or row_valid.shape[0] != m:
        raise ValueError(
            f"relax_level_: shapes disagree: dst {tuple(dst.shape)}, "
            f"src_idx {tuple(src_idx.shape)}, w {tuple(w.shape)}, "
            f"row_valid {tuple(row_valid.shape)}")


def relax_level_(dist: torch.Tensor, dst: torch.Tensor,
                 src_idx: torch.Tensor, w: torch.Tensor,
                 row_valid: torch.Tensor) -> torch.Tensor:
    """Relax one sweep-plan level into ``dist`` in place and return it:

        for each valid row m and each source s:
            dist[s, dst[m]] = min(dist[s, dst[m]],
                                  min_k dist[s, src_idx[m, k]] + w[m, k])

    ``dist`` [S, N] f32; ``dst`` [M] int32; ``src_idx`` [M, K] int32
    with indices in ``[0, N)``; ``w`` [M, K] f32 (+inf padding);
    ``row_valid`` [M] bool.  The level's gathered and written nodes must
    be disjoint, as every plan level's are.  ``relax_level_.launches``
    counts kernel launches.
    """
    if dist.device.type == "cpu":
        return relax_level_ref_(dist, dst, src_idx, w, row_valid)
    _check(dist, dst, src_idx, w, row_valid)
    s, m = dist.shape[0], dst.shape[0]
    if s == 0 or m == 0:
        return dist
    fn = load("edge_relax").edge_relax_level
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(dist.data_ptr(), dst.data_ptr(), src_idx.data_ptr(),
             w.data_ptr(), row_valid.data_ptr(), s, m, src_idx.shape[1],
             dist.stride(0), torch.cuda.current_stream(dist.device)
             .cuda_stream)
    if err:
        raise RuntimeError(f"edge_relax launch failed: CUDA error {err}")
    relax_level_.launches += 1
    return dist


relax_level_.launches = 0
