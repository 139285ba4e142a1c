"""Wrapper of the fused gather and bag-sum (``csrc/embedding_bag.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.
"""
import ctypes

import torch

from .._build import load
from .ref import bag_sum_ref, take_fill

__all__ = ["bag_sum"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(table, ids, mask) -> None:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"bag_sum: table must be on the CPU or a CUDA "
                         f"device, got {dev}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bag_sum: table must be float32 or bfloat16, got "
                         f"{table.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"bag_sum: ids must be int32, got {ids.dtype}")
    for name, t in (("table", table), ("ids", ids), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"bag_sum: {name} is on {t.device}, table on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"bag_sum: {name} must be contiguous")
    if table.shape[0] >= 2 ** 31:
        raise ValueError("bag_sum: int32 ids address at most 2**31 - 1 rows")


def bag_sum(table: torch.Tensor, ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Multi-hot EmbeddingBag: table [V, D] f32 or bf16, ids [B, K]
    int32 (padded), mask [B, K] (bool or float) -> [B, D] bag sums

        out[b, :] = sum_k mask[b, k] * table[ids[b, k], :]

    with ``jnp.take(..., fill_value=0)``'s ids: negative ids wrap once,
    ids outside ``[0, V)`` after that give a zero row.  The output has
    the table's dtype.  ``bag_sum.launches`` counts kernel launches.
    """
    if table.dim() != 2 or ids.dim() != 2 or mask.shape != ids.shape:
        raise ValueError(f"bag_sum: table must be [V, D], ids and mask "
                         f"[B, K]; got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}")
    if table.device.type == "cpu" and ids.device.type == "cpu" \
            and mask.device.type == "cpu":
        return bag_sum_ref(take_fill(table, ids), mask)
    mask = mask.to(table.dtype)          # the JAX kernel's cast
    _check(table, ids, mask)
    v, d = table.shape
    b, k = ids.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    fn = load("embedding_bag").bag_sum
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
             out.data_ptr(), v, b, k, d,
             int(table.dtype == torch.bfloat16),
             torch.cuda.current_stream(table.device).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    bag_sum.launches += 1
    return out


bag_sum.launches = 0
