"""Wrappers of the fused gather and bag-sum (``csrc/embedding_bag.cu``)
and of its table gradient, and the ``torch.autograd.Function`` that
joins them.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  Nothing falls back from one to the other.
"""
import ctypes
import functools
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import note_fake_launch
from .._build import load
from .ref import backward_plan, bag_sum_backward_ref, bag_sum_ref, take_fill

__all__ = ["bag_sum", "bag_sum_backward", "backward_index", "plan_backward",
           "bag_sum_cost", "bag_sum_backward_cost"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SORT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_REDUCE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]

#: Keys a block of the backward's sort passes ranks (256 threads x 17: the
#: train shape's 392 tiles fit the H100's 132 SMs at 3 blocks each).
SORT_TILE = 4352
#: The widest digit a sort pass takes: 256 buckets, one a thread.
SORT_DIGIT_BITS = 8
SORT_RADIX = 1 << SORT_DIGIT_BITS
#: Sorted slots a chunk of the backward's runs pass: a run of one row
#: longer than this is summed in parts, combined in chunk order.  Sized
#: for the pass's eight rows in flight a lane, not for latency.
BWD_CHUNK = 128


def bag_sum_cost(b: int, k: int, d: int, rows: int,
                 row_bytes: int = 4) -> "tuple[int, int]":
    """(bytes, operations) of one :func:`bag_sum` call on B bags of K
    slots: each of the ``rows`` distinct rows the ids name gathered once
    and the [B, D] output written (``row_bytes`` an element, the table's
    dtype), ids and mask in (4 bytes a slot each); a multiply and an add
    an element a slot."""
    return (row_bytes * d * (rows + b) + 8 * b * k, 2 * b * k * d)


def bag_sum_backward_cost(b: int, k: int, d: int,
                          touched: int) -> "tuple[int, int]":
    """(bytes, operations) of one :func:`bag_sum_backward` call: the f32
    ``grad_out`` [B, D], ids and mask (4 bytes a slot each) read once,
    each of the ``touched`` rows the ids name written once; a multiply
    and an add an element a slot."""
    return (4 * b * d + 8 * b * k + 4 * d * touched, 2 * b * k * d)


class BackwardPlan(NamedTuple):
    """The launch plan of :func:`bag_sum_backward` on the card."""
    bits: int                  # key width: n_rows, the sentinel, fits
    digits: tuple              # (shift, width) a sort pass, low digit first
    tiles: int                 # SORT_TILE-key tiles a pass
    zero_bytes: int            # zeroed scratch: look-back words, counts,
                               # tile counters
    chunk: int                 # sorted slots a chunk of the runs pass
    n_chunks: int


def plan_backward(n: int, n_rows: int) -> BackwardPlan:
    """The backward's plan for ``n`` slots over ``n_rows`` rows: a stable
    LSD radix sort over ``n_rows.bit_length()`` key bits (at least 1; the
    key ``n_rows`` marks a slot that adds nothing, so it must fit), in
    the fewest passes of at most SORT_DIGIT_BITS bits, the widths as even
    as they go, wider ones first; the runs pass in chunks of BWD_CHUNK.
    At dlrm-rm2's train shape (26e6 rows): 25 bits in 4 passes of 7, 6,
    6, 6.  Raises when the int32 slot values or rows cannot hold the
    shape."""
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"bag_sum_backward: B*K = {n} slots; int32 slot "
                         f"indices address at most 2**31 - 1")
    if not 0 <= n_rows < 2 ** 31:
        raise ValueError(f"bag_sum_backward: {n_rows} rows; int32 rows "
                         f"address at most 2**31 - 1")
    bits = max(1, n_rows.bit_length())
    passes = -(-bits // SORT_DIGIT_BITS)
    base, extra = divmod(bits, passes)
    widths = [base + (i < extra) for i in range(passes)]
    shifts = [sum(widths[:i]) for i in range(passes)]
    tiles = -(-n // SORT_TILE)
    zero_bytes = 8 * passes * tiles * SORT_RADIX \
        + 4 * passes * (SORT_RADIX + 1)
    return BackwardPlan(bits, tuple(zip(shifts, widths)), tiles,
                        zero_bytes, BWD_CHUNK, -(-n // BWD_CHUNK))


def _packed_widths(plan: BackwardPlan) -> int:
    """The digits' widths as the kernel reads them, a byte a pass."""
    return sum(w << (8 * i) for i, (_, w) in enumerate(plan.digits))


def _scratch(plan: BackwardPlan, n: int, d: int, device) -> dict:
    """What one card call allocates besides its output: the sorted rows
    and slots, the sort's other buffer, its zeroed words and the runs
    pass's head and tail parts."""
    return {"sorted": torch.empty((2, n), dtype=torch.int32, device=device),
            "tmp": torch.empty((2, n), dtype=torch.int32, device=device),
            "zero": torch.empty(-(-plan.zero_bytes // 8), dtype=torch.int64,
                                device=device),
            "parts": torch.empty((2, plan.n_chunks, d), dtype=torch.float32,
                                 device=device)}


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    """The backward's entry points, argument types set once."""
    lib = load("embedding_bag")
    lib.bag_bwd_sort.argtypes = _SORT_ARGTYPES
    lib.bag_bwd_sort.restype = ctypes.c_int
    lib.bag_bwd_reduce.argtypes = _REDUCE_ARGTYPES
    lib.bag_bwd_reduce.restype = ctypes.c_int
    return lib


def _launch_sort(lib, ids, n_rows: int, plan: BackwardPlan, scratch: dict,
                 stream: int):
    """Launch the index preparation; returns (rows, slots), int32."""
    rows, slots = scratch["sorted"]
    keys, vals = scratch["tmp"]
    err = lib.bag_bwd_sort(ids.data_ptr(), rows.data_ptr(), slots.data_ptr(),
                           keys.data_ptr(), vals.data_ptr(),
                           scratch["zero"].data_ptr(), plan.zero_bytes,
                           ids.numel(), n_rows, plan.tiles,
                           _packed_widths(plan), stream)
    if err:
        raise RuntimeError(f"embedding_bag backward sort launch failed: "
                           f"CUDA error {err}")
    return rows, slots


def _launch_reduce(lib, rows, slots, mask, grad_out, out, n_slots: int,
                   plan: BackwardPlan, parts, which: int, stream: int):
    """Launch the runs pass (``which`` 1), the carry pass (2) or both (3)
    over sorted ``rows``/``slots`` into ``out``."""
    err = lib.bag_bwd_reduce(rows.data_ptr(), slots.data_ptr(),
                             mask.data_ptr(), grad_out.data_ptr(),
                             out.data_ptr(), parts[0].data_ptr(),
                             parts[1].data_ptr(), rows.numel(),
                             out.shape[0], n_slots, out.shape[1],
                             plan.chunk, which, stream)
    if err:
        raise RuntimeError(f"embedding_bag backward launch failed: CUDA "
                           f"error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def backward_index(ids: torch.Tensor, n_rows: int):
    """The backward's index preparation alone: (rows ascending, slots),
    the slots of ``ids`` stably sorted by row as :func:`backward_plan`
    reads them.  On the CPU it is :func:`backward_plan` (slots int64); on
    the card the radix sort kernels (slots int32, the same values)."""
    if _on_cpu(ids):
        return backward_plan(ids, n_rows)
    if ids.device.type != "cuda" or ids.dtype != torch.int32 \
            or not ids.is_contiguous():
        raise ValueError(f"backward_index: ids must be contiguous int32 on "
                         f"the CPU or a CUDA device, got {ids.dtype} on "
                         f"{ids.device}")
    n = ids.numel()
    plan = plan_backward(n, n_rows)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=ids.device)
        return empty, empty.clone()
    scratch = _scratch(plan, n, 0, ids.device)
    return _launch_sort(_bwd_lib(), ids, n_rows, plan, scratch,
                        _stream(ids.device))


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
    v, d = table.shape
    b, k = ids.shape
    if isinstance(table, FakeTensor):
        # the fake form: the ids are unknown, so every slot's row is
        # counted as a distinct one
        note_fake_launch("embedding_bag", *bag_sum_cost(
            b, k, d, min(b * k, v), table.element_size()), table.dtype)
        return torch.empty((b, d), dtype=table.dtype, device=table.device)
    _check(table, ids, mask)
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
    sorted by row by this file's radix sort kernels (index preparation,
    :func:`backward_index`), and the kernels sum each row's run of slots
    and write each touched row once, with no float atomics, so the
    result is the same bits at every launch.  ``out``, if given, must be
    zero outside the rows the ids touch (a zero fill, or the same call's
    earlier output); it is written and returned, and the zero fill of a
    new ``out`` is a separate ``torch.zeros``.
    ``bag_sum_backward.launches`` counts calls that reach the card; each
    makes ``len(plan.digits) + 4`` launches (:func:`plan_backward`): a
    memset, the histogram, a sort pass a digit, the runs pass and the
    carry pass."""
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
    fake = isinstance(grad_out, FakeTensor)
    if not fake:
        _check(grad_out, ids, mask)
    b, k = ids.shape
    d = grad_out.shape[1]
    n = b * k
    plan = plan_backward(n, n_rows)
    if out is None:
        out = torch.zeros((n_rows, d), dtype=torch.float32,
                          device=grad_out.device)
    elif out.shape != (n_rows, d) or out.dtype != torch.float32 \
            or out.device != grad_out.device or not out.is_contiguous():
        raise ValueError(f"bag_sum_backward: out must be a contiguous "
                         f"[{n_rows}, {d}] float32 tensor on "
                         f"{grad_out.device}")
    if n == 0 or d == 0 or n_rows == 0:
        return out
    scratch = _scratch(plan, n, d, grad_out.device)
    if fake:
        # the fake form: the zero fill and the scratch as on the card;
        # every slot's row counted as a distinct one
        note_fake_launch("bag_sum_backward", *bag_sum_backward_cost(
            b, k, d, min(n, n_rows)), torch.float32)
        return out
    lib, stream = _bwd_lib(), _stream(grad_out.device)
    rows, slots = _launch_sort(lib, ids, n_rows, plan, scratch, stream)
    _launch_reduce(lib, rows, slots, mask, grad_out, out, k, plan,
                   scratch["parts"], 3, stream)
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
