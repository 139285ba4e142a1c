"""The planners of the port's redesigned kernels, on the CPU.

``flash_decode``'s ``plan_splits`` cuts each (batch, KV head) pair's
valid positions into splits of whole tiles; ``tropical_matmul``'s
``plan_split_k`` cuts K into chunks of whole K tiles and ``copy_widths``
picks the cp.async width each operand allows; ``embedding_bag``'s
``plan_backward`` picks the radix sort's key width and digits and the
runs pass's chunks.  The kernels trust these plans (a gap or an overlap
would be a wrong answer, an empty split a wasted block), so they are
checked here as plain Python, over random shapes and at the shapes
``PERF.md`` states.
"""
import numpy as np
import pytest
import torch

from hypsupport import given, settings, st
from repro_torch.kernels.embedding_bag import backward_plan
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ops import (SORT_DIGIT_BITS,
                                                   SORT_RADIX, SORT_TILE,
                                                   plan_backward)
from repro_torch.kernels.flash_decode.ops import TILE, plan_splits
from repro_torch.kernels.tropical_matmul.ops import (BK, BM, BN, copy_widths,
                                                     plan_split_k)

H100_SMS = 132


def _cover(n: int, size: int, count: int) -> list:
    """The ranges [i*size, min((i+1)*size, n)) of ``count`` splits."""
    return [(i * size, min((i + 1) * size, n)) for i in range(count)]


def _assert_partition(ranges, n: int) -> None:
    """The ranges are non-empty, in order, and cover [0, n) once."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
        assert hi == nlo
    assert all(hi > lo for lo, hi in ranges)


# ------------------------------------------------------------ flash_decode
@settings(max_examples=300, deadline=None)
@given(st.integers(1, 256), st.integers(1, 16), st.integers(1, 70000),
       st.integers(1, 70000), st.integers(1, 160), st.integers(1, 4))
def test_flash_plan_covers_every_position_once(b, kh, kv_len, s, sms, per_sm):
    n_valid = min(kv_len, s)             # what the wrapper plans over
    n_split, split_len = plan_splits(b, kh, n_valid, sms, per_sm)
    assert n_split >= 1 and split_len % TILE == 0 and split_len > 0
    _assert_partition(_cover(n_valid, split_len, n_split), n_valid)
    # one length for all but the last, which is the only short one
    assert (n_split - 1) * split_len < n_valid <= n_split * split_len


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 256), st.integers(1, 16), st.integers(1, 70000),
       st.integers(1, 160), st.integers(1, 4))
def test_flash_plan_stays_in_one_wave(b, kh, n_valid, sms, per_sm):
    """Every block is resident at once when the pairs alone fit, and no
    split is cut finer than one wave asks."""
    n_split, split_len = plan_splits(b, kh, n_valid, sms, per_sm)
    slots = sms * per_sm
    if b * kh <= slots:
        assert b * kh * n_split <= slots
    else:
        assert n_split == 1
    tiles = -(-n_valid // TILE)
    assert n_split <= tiles


@pytest.mark.parametrize("kv_len,want", [
    (32761, (4, 8192)),          # decode_32k's timed step (PERF.md)
    (32768, (4, 8192)), (20001, (4, 5056)), (1, (1, 64))])
def test_flash_plan_at_decode_32k(kv_len, want):
    """glm4's decode_32k layer on the H100: B 32, both KV heads in one
    block, one block an SM (and the same cut with a head a block, two
    blocks an SM)."""
    assert plan_splits(32, 1, kv_len, H100_SMS, 1) == want
    assert plan_splits(32, 2, kv_len, H100_SMS, 2) == want


@pytest.mark.parametrize("b,kv_len,want", [
    (16, 32761, (1, 32768)),     # decode_32k, a global layer
    (16, 1024, (1, 1024)),       # a local layer's rolling cache, full
    (16, 601, (1, 640)),         # ... before it wraps
    (1, 524281, (16, 32768)),    # long_500k, a global layer
    (1, 1024, (16, 64))])        # long_500k, a local layer
def test_flash_plan_at_gemma3(b, kv_len, want):
    """gemma3's decode layers on the H100: 8 KV heads at dh 256, one a
    block, one block an SM."""
    assert plan_splits(b, 8, kv_len, H100_SMS, 1) == want


def test_flash_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        plan_splits(1, 1, 0, H100_SMS, 2)


# ---------------------------------------------------------- tropical_matmul
def _makespan(m, n, k, per, slots):
    """The planner's cost of chunks of ``per`` K tiles, written out."""
    k_tiles = -(-k // BK)
    n_k = -(-k_tiles // per)
    blocks = -(-n // BN) * -(-m // BM) * n_k
    return -(-blocks // slots) * (per + 1)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 80), st.integers(1, 20000), st.integers(1, 20000),
       st.integers(1, 160), st.integers(1, 4))
def test_split_k_covers_k_once_in_whole_tiles(m, n, k, sms, per_sm):
    plan = plan_split_k(m, n, k, sms, per_sm)
    assert plan.chunk % BK == 0 and plan.n_k >= 1
    _assert_partition(_cover(k, plan.chunk, plan.n_k), k)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 80), st.integers(1, 20000), st.integers(1, 20000),
       st.integers(1, 160), st.integers(1, 4))
def test_split_k_grid_and_waves(m, n, k, sms, per_sm):
    """The grid is what the plan claims, in exactly ``waves`` waves of the
    resident blocks, and no other whole-tile chunking has a shorter
    makespan."""
    plan = plan_split_k(m, n, k, sms, per_sm)
    slots = sms * per_sm
    assert plan.blocks == -(-n // BN) * -(-m // BM) * plan.n_k
    assert (plan.waves - 1) * slots < plan.blocks <= plan.waves * slots
    k_tiles = -(-k // BK)
    best = min(_makespan(m, n, k, per, slots) for per in range(1, k_tiles + 1))
    assert _makespan(m, n, k, plan.chunk // BK, slots) == best


@pytest.mark.parametrize("m,k,n,per_sm,want", [
    (32, 15722, 15722, 4, (17, 928, 2091, 4)),   # the HoD core search on
    (32, 15722, 15722, 3, (16, 992, 1968, 5)),   # the H100 (4 blocks an
    (32, 15722, 15722, 2, (15, 1056, 1845, 7)),  # SM; fewer for contrast)
    (1, 5, 3, 3, (1, 32, 1, 1)),                  # K below one tile
    (33, 1001, 777, 3, (16, 64, 224, 1))])
def test_split_k_at_main_path_shapes(m, k, n, per_sm, want):
    assert tuple(plan_split_k(m, n, k, H100_SMS, per_sm)) == want


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 20000), st.integers(1, 20000), st.integers(0, 64),
       st.integers(0, 1 << 20), st.integers(0, 1 << 20))
def test_copy_widths_are_the_widest_that_fit(n, k, pad, a_off, b_off):
    """A copy of ``a`` never straddles K or leaves its row and is aligned;
    a copy of ``b`` likewise with N; the next wider width breaks one of
    those."""
    lda = k + pad
    a_ptr, b_ptr = 4 * a_off, 4 * b_off
    va, vb = copy_widths(n, k, lda, a_ptr, b_ptr)

    def fits(v, ptr, *sizes):
        return ptr % v == 0 and all(s % (v // 4) == 0 for s in sizes)

    assert fits(va, a_ptr, lda, k) and fits(vb, b_ptr, n)
    assert va == 16 or not fits(2 * va, a_ptr, lda, k)
    assert vb == 16 or not fits(2 * vb, b_ptr, n)


def test_copy_widths_at_the_core_search():
    """C = 15,722 is even but not a multiple of 4: b's rows take 8-byte
    copies; the label state's core block keeps the state's alignment."""
    assert copy_widths(15722, 15722, 15722, 0, 0) == (8, 8)
    assert copy_widths(15722, 15722, 40000, 4 * 24278, 256) == (8, 8)
    assert copy_widths(15724, 15724, 15724, 0, 0) == (16, 16)
    assert copy_widths(7, 5, 9, 4, 12) == (4, 4)


# ---------------------------------------------------- bag_sum_backward
def _assert_digits(plan, n_rows: int) -> None:
    """The key width holds every key, the sentinel n_rows among them;
    the digits cover [0, bits) once, low digit first, each 1-8 bits, in
    the fewest passes, their widths at most one apart."""
    assert n_rows < 2 ** plan.bits and plan.bits >= 1
    assert plan.bits == max(1, n_rows.bit_length())
    covered = 0
    for shift, width in plan.digits:
        assert shift == covered and 1 <= width <= SORT_DIGIT_BITS
        covered += width
    assert covered == plan.bits
    assert len(plan.digits) == -(-plan.bits // SORT_DIGIT_BITS)
    widths = [w for _, w in plan.digits]
    assert max(widths) - min(widths) <= 1


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 2 ** 31 - 1))
def test_backward_plan_key_width_and_digits(n, n_rows):
    _assert_digits(plan_backward(n, n_rows), n_rows)


@pytest.mark.parametrize("k", range(31))
def test_backward_plan_at_powers_of_two(k):
    """2**k - 1, 2**k and 2**k + 1 rows: the sentinel n_rows needs
    bit_length bits, one more than the rows below it at n_rows = 2**k."""
    for n_rows in (2 ** k - 1, 2 ** k, 2 ** k + 1):
        if n_rows < 2 ** 31:
            _assert_digits(plan_backward(1000, n_rows), n_rows)
    assert plan_backward(1000, 2 ** k).bits == k + 1


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(0, 2 ** 20))
def test_backward_plan_chunks_and_tiles_partition_the_slots(n, n_rows):
    """Chunks of ``chunk`` slots and tiles of SORT_TILE keys cover [0, n)
    once, none empty: written out where n is small, and for any n the
    last one ends at n and starts below it."""
    plan = plan_backward(n, n_rows)
    assert plan.chunk == eb_ops.BWD_CHUNK
    for size, count in ((plan.chunk, plan.n_chunks),
                        (SORT_TILE, plan.tiles)):
        assert (count - 1) * size < n <= count * size or n == count == 0
        if 0 < n <= 2 ** 16:
            _assert_partition(_cover(n, size, count), n)


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 2 ** 31 - 1), st.integers(0, 2 ** 31 - 1),
       st.integers(1, 300))
def test_backward_scratch_is_what_the_kernels_index(n, n_rows, d):
    """The wrapper's allocation (``ops._scratch``, on the meta device)
    holds the sorted rows and slots and the sort's other buffer (n int32
    each), the look-back words ([passes][tiles][256] u64), the digit
    counts ([passes][256] u32) and tile counters ([passes] u32) that the
    C entry point zeroes, and the runs pass's head and tail parts."""
    plan = plan_backward(n, n_rows)
    got = eb_ops._scratch(plan, n, d, "meta")
    passes = len(plan.digits)
    need = 8 * passes * plan.tiles * SORT_RADIX + 4 * passes * SORT_RADIX \
        + 4 * passes
    assert plan.zero_bytes == need
    assert got["zero"].dtype == torch.int64
    assert got["zero"].numel() * 8 >= need > (got["zero"].numel() - 1) * 8
    for name in ("sorted", "tmp"):
        assert got[name].shape == (2, n) and got[name].dtype == torch.int32
    assert got["parts"].shape == (2, plan.n_chunks, d)
    assert got["parts"].dtype == torch.float32


def test_backward_plan_at_the_train_shape():
    """dlrm-rm2's train_batch: 26 x 10^6 rows need 25 key bits (the
    sentinel 26,000,000 < 2**25), in 4 passes of 7, 6, 6, 6; 1,703,936
    slots make 392 tiles (at most 3 an SM of the H100's 132) and 13,312
    chunks of 128."""
    plan = plan_backward(65536 * 26, 26_000_000)
    assert plan.bits == 25
    assert plan.digits == ((0, 7), (7, 6), (13, 6), (19, 6))
    assert (plan.tiles, plan.chunk, plan.n_chunks) == (392, 128, 13312)
    assert eb_ops._packed_widths(plan) == 7 | 6 << 8 | 6 << 16 | 6 << 24


@pytest.mark.parametrize("n,n_rows", [(2 ** 31, 10), (2 ** 40, 10),
                                      (-1, 10), (10, 2 ** 31), (10, -1)])
def test_backward_plan_refuses_what_int32_cannot_address(n, n_rows):
    """B*K >= 2**31 slots (int32 slot values) or rows outside int32 are
    refused by the pure planner, before anything is allocated."""
    with pytest.raises(ValueError, match="int32"):
        plan_backward(n, n_rows)
    plan_backward(2 ** 31 - 1, 2 ** 31 - 1)        # the largest that fits


@pytest.mark.parametrize("n_rows,b,k,seed", [
    (1, 500, 1, 0), (255, 3000, 2, 1), (256, 3000, 2, 2),
    (257, 3000, 1, 3), (26_000_000, 65536, 1, 4), (1000, 20000, 3, 5)])
def test_planned_digit_passes_equal_backward_plan(n_rows, b, k, seed):
    """A CPU model of the kernels' passes: the keys by take_fill's rule
    (the sentinel n_rows for a slot that adds nothing), then one stable
    sort a planned digit, low digit first, carrying the slot index.  On
    Zipf ids with negative and out-of-range ones it gives
    ``backward_plan``'s (rows, slots)."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.zipf(1.2, (b, k)) - 1, n_rows - 1)
    ids = ids.astype(np.int64) * rng.choice([1, 7919], (b, k)) % n_rows
    pick = rng.permutation(b * k)[:b * k // 10]
    ids.reshape(-1)[pick] = rng.integers(-2 * n_rows - 2, 2 * n_rows + 2,
                                         pick.size)
    ids = torch.from_numpy(ids.astype(np.int32))
    flat = ids.reshape(-1).long()
    idx = torch.where(flat < 0, flat + n_rows, flat)
    keys = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    vals = torch.arange(keys.numel())
    for shift, width in plan_backward(keys.numel(), n_rows).digits:
        digit = (keys >> shift) & ((1 << width) - 1)
        order = torch.sort(digit, stable=True).indices
        keys, vals = keys[order], vals[order]
    rows, slots = backward_plan(ids, n_rows)
    assert torch.equal(keys.to(torch.int32), rows)
    assert torch.equal(vals, slots)
