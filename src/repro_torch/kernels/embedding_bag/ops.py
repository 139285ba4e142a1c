"""Wrappers of the fused gather and bag-sum (``csrc/embedding_bag.cu``)
and of its table gradient, and the ``torch.autograd.Function`` that
joins them.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  Nothing falls back from one to the other.
"""
import ctypes

import torch

from .._build import load
from .ref import backward_plan, bag_sum_backward_ref, bag_sum_ref, take_fill

__all__ = ["bag_sum", "bag_sum_backward"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]

#: Sorted slots a chunk of the backward's first pass: a run of one row
#: longer than this is summed in parts, combined in chunk order.
BWD_CHUNK = 32


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


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _bag_sum_forward(table, ids, mask):
    """The forward: the plain version on the CPU, the kernel on the card
    (counted in ``bag_sum.launches``)."""
    if _on_cpu(table, ids, mask):
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


def bag_sum_backward(grad_out: torch.Tensor, ids: torch.Tensor,
                     mask: torch.Tensor, n_rows: int,
                     out: torch.Tensor = None) -> torch.Tensor:
    """The dense table gradient of :func:`bag_sum`: grad_out [B, D] f32,
    ids [B, K] int32, mask [B, K] -> [n_rows, D] f32 with

        d_table[r, :] = sum over slots (b, k) naming row r of
                        mask[b, k] * grad_out[b, :]

    (ids read as the forward reads them).  On the card the slots are
    sorted by row (``torch.sort``, stable: index preparation) and the
    kernel sums each row's run of slots and writes each touched row
    once, with no atomics, so the result is the same bits at every
    launch.  ``out``, if given, must be zero outside the rows the ids
    touch (a zero fill, or the same call's earlier output); it is
    written and returned, and the zero fill of a new ``out`` is a
    separate ``torch.zeros``.  ``bag_sum_backward.launches`` counts
    calls that reach the card; each launches two kernels, the runs pass
    and the carry pass."""
    if grad_out.dim() != 2 or ids.dim() != 2 or mask.shape != ids.shape \
            or grad_out.shape[0] != ids.shape[0]:
        raise ValueError(f"bag_sum_backward: grad_out must be [B, D], ids "
                         f"and mask [B, K]; got {tuple(grad_out.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}")
    if grad_out.dtype != torch.float32:
        raise ValueError(f"bag_sum_backward: float32 tables only, got "
                         f"{grad_out.dtype} (nothing trains bf16 tables)")
    if _on_cpu(grad_out, ids, mask):
        ref = bag_sum_backward_ref(grad_out, ids, mask, n_rows)
        return ref if out is None else out.copy_(ref)
    mask = mask.to(torch.float32).contiguous()
    _check(grad_out, ids, mask)
    if not 0 <= n_rows < 2 ** 31:
        raise ValueError("bag_sum_backward: int32 rows address at most "
                         "2**31 - 1 rows")
    b, k = ids.shape
    d = grad_out.shape[1]
    if out is None:
        out = torch.zeros((n_rows, d), dtype=torch.float32,
                          device=grad_out.device)
    elif out.shape != (n_rows, d) or out.dtype != torch.float32 \
            or out.device != grad_out.device or not out.is_contiguous():
        raise ValueError(f"bag_sum_backward: out must be a contiguous "
                         f"[{n_rows}, {d}] float32 tensor on "
                         f"{grad_out.device}")
    n = b * k
    if n == 0 or d == 0 or n_rows == 0:
        return out
    rows, slots = backward_plan(ids, n_rows)
    n_chunks = -(-n // BWD_CHUNK)
    parts = torch.empty((2, n_chunks, d), dtype=torch.float32,
                        device=grad_out.device)
    fn = load("embedding_bag").bag_sum_backward
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    err = fn(rows.data_ptr(), slots.data_ptr(), mask.data_ptr(),
             grad_out.data_ptr(), out.data_ptr(), parts[0].data_ptr(),
             parts[1].data_ptr(), n, n_rows, k, d, BWD_CHUNK,
             torch.cuda.current_stream(grad_out.device).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag backward launch failed: CUDA "
                           f"error {err}")
    bag_sum_backward.launches += 1
    return out


bag_sum_backward.launches = 0


class BagSum(torch.autograd.Function):
    """:func:`bag_sum` with its table gradient.  ids and mask get none."""

    @staticmethod
    def forward(ctx, table, ids, mask):
        ctx.save_for_backward(ids, mask)
        ctx.n_rows, ctx.table_dtype = table.shape[0], table.dtype
        return _bag_sum_forward(table, ids, mask)

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.table_dtype != torch.float32:
            raise NotImplementedError(
                f"bag_sum: a {ctx.table_dtype} table has no backward "
                "(float32 tables only: nothing in the JAX package trains "
                "bf16 tables)")
        ids, mask = ctx.saved_tensors
        return (bag_sum_backward(grad_out.contiguous(), ids, mask,
                                 ctx.n_rows), None, None)


def bag_sum(table: torch.Tensor, ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Multi-hot EmbeddingBag: table [V, D] f32 or bf16, ids [B, K]
    int32 (padded), mask [B, K] (bool or float) -> [B, D] bag sums

        out[b, :] = sum_k mask[b, k] * table[ids[b, k], :]

    with ``jnp.take(..., fill_value=0)``'s ids: negative ids wrap once,
    ids outside ``[0, V)`` after that give a zero row.  The output has
    the table's dtype.  Differentiable in ``table`` (f32 only) through
    :class:`BagSum`, whose backward is :func:`bag_sum_backward`; a mask
    that requires grad is refused.  ``bag_sum.launches`` counts forward
    kernel launches.
    """
    if table.dim() != 2 or ids.dim() != 2 or mask.shape != ids.shape:
        raise ValueError(f"bag_sum: table must be [V, D], ids and mask "
                         f"[B, K]; got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}")
    if mask.requires_grad:
        raise ValueError("bag_sum: the mask gets no gradient; pass it "
                         "detached")
    return BagSum.apply(table, ids, mask)


bag_sum.launches = 0
