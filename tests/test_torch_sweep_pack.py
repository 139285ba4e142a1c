"""The sweep packer and the sweep kernel's launch plan, on the CPU.

``pack_sweep`` turns a sweep's bucketed plan levels into the compacted
rows ``relax_sweep_`` reads: one row per distinct destination a level,
only the finite slots of valid rows, levels behind a level pointer.  The
kernel trusts that layout (a missed slot or a second writer of one label
would be a wrong answer), so it is checked here as plain numpy, over
random sweeps and on a real index, and relaxed against the bucketed
levels bit for bit.  ``plan_sweep_launch`` sizes the cooperative grid.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from hypsupport import given, settings, st
from repro_torch.core.query import _plan_sweep
from repro_torch.kernels.edge_relax import (pack_sweep, relax_sweep_,
                                            relax_sweep_ref_)
from repro_torch.kernels.edge_relax.ops import plan_sweep_launch
from repro_torch.kernels.edge_relax.sweep import SLOTS_A_THREAD, ways_of
from torchsupport import plan_like_sweep, relax_levels_np, t

H100_SMS = 132


def _np(sweep):
    return {f: getattr(sweep, f).numpy() for f in
            ("levels", "row_dst", "row_ptr", "src", "w")}


def _assert_layout(sweep, levels):
    """Pointers consistent; per level, one row per distinct destination
    of a valid row with a finite slot, ascending, holding exactly that
    destination's finite valid slots (as a multiset)."""
    a = _np(sweep)
    assert sweep.n_levels == len(levels)
    assert tuple(a["levels"].tolist()) == sweep.level_rows
    assert sweep.level_rows[0] == 0 and \
        sweep.level_rows[-1] == a["row_dst"].size
    assert a["row_ptr"][0] == 0 and a["row_ptr"][-1] == a["src"].size
    assert np.all(np.diff(a["levels"]) >= 0)
    assert np.all(np.diff(a["row_ptr"]) > 0)          # no empty row
    assert tuple(a["row_ptr"][a["levels"]].tolist()) == sweep.level_slots
    assert np.isfinite(a["w"]).all()
    for i, (dst, src, w, valid) in enumerate(levels):
        r0, r1 = sweep.level_rows[i:i + 2]
        rows = a["row_dst"][r0:r1]
        assert np.all(np.diff(rows) > 0)              # merged, ascending
        keep = valid[:, None] & np.isfinite(w)
        want = {}
        for m, j in zip(*np.nonzero(keep)):
            want.setdefault(int(dst[m]), []).append(
                (int(src[m, j]), float(w[m, j])))
        assert rows.tolist() == sorted(want)
        for r, d in zip(range(r0, r1), rows.tolist()):
            e0, e1 = a["row_ptr"][r], a["row_ptr"][r + 1]
            got = sorted(zip(a["src"][e0:e1].tolist(),
                             a["w"][e0:e1].tolist()))
            assert got == sorted(want[d])


@pytest.mark.parametrize("s,n,n_levels,m,k,empty", [
    (1, 60, 1, 9, 1, ()), (4, 300, 3, 40, 5, ()), (7, 500, 4, 64, 16, (1,)),
    (33, 2000, 5, 200, 9, (0, 4)), (2, 100, 3, 16, 3, (0, 1, 2))])
def test_pack_merges_rows_and_relaxes_like_the_levels(s, n, n_levels, m, k,
                                                      empty):
    """Rows merged per destination, invalid rows and +inf slots dropped,
    empty levels kept as empty ranges; the packed sweep relaxes bit-equal
    to the bucketed levels, and so does each level run alone in turn."""
    dist, levels = plan_like_sweep(s, n, n_levels, m, k, seed=n + m,
                                   empty=empty)
    sweep = pack_sweep(levels, n + 1)
    _assert_layout(sweep, levels)
    for i in empty:
        assert sweep.level_rows[i] == sweep.level_rows[i + 1]
    want = relax_levels_np(dist, levels)
    got = relax_sweep_(t(dist.copy()), sweep).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[n]).all()
    one_at_a_time = t(dist.copy())
    for i in range(sweep.n_levels):
        relax_sweep_ref_(one_at_a_time, sweep.level(i))
    np.testing.assert_array_equal(one_at_a_time.numpy(), want)


def test_zero_level_sweep():
    sweep = pack_sweep([], 5)
    assert sweep.n_levels == 0 and sweep.level_widths == ()
    assert sweep.level_max_slots == () and sweep.ways.shape == (6, 0)
    assert sweep.level_rows == (0,) and sweep.level_slots == (0,)
    dist = t(np.arange(10, dtype=np.float32).reshape(5, 2))
    np.testing.assert_array_equal(relax_sweep_(dist.clone(), sweep), dist)
    with pytest.raises(IndexError):
        sweep.level(0)


def test_level_views_share_the_sweep():
    _, levels = plan_like_sweep(3, 400, 4, 50, 6, seed=2)
    sweep = pack_sweep(levels, 401)
    one = sweep.level(2)
    assert one.n_levels == 1
    assert one.level_rows == sweep.level_rows[2:4]
    assert one.levels.tolist() == list(sweep.level_rows[2:4])
    assert one.levels.data_ptr() == sweep.levels.data_ptr() + 2 * 4
    assert one.src is sweep.src
    assert one.level_widths == (sweep.level_rows[3] - sweep.level_rows[2],)
    assert one.level_max_slots == sweep.level_max_slots[2:3]
    for j in range(6):
        assert one.ways[j].tolist() == [sweep.ways[j, 2].item()]
        assert one.ways[j].data_ptr() == sweep.ways[j, 2].data_ptr()


def test_split_rows_merge():
    """Two rows of one destination (a split in-edge list) become one row
    holding both rows' finite slots; an invalid row of the same
    destination adds nothing."""
    dst = np.array([7, 7, 7, 8], np.int32)
    src = np.array([[1, 2], [3, 9], [4, 4], [2, 9]], np.int32)
    w = np.array([[1, 2], [3, np.inf], [0, 0], [5, np.inf]], np.float32)
    valid = np.array([True, True, False, True])
    sweep = pack_sweep([(dst, src, w, valid)], 10)
    assert sweep.row_dst.tolist() == [7, 8]
    assert sweep.row_ptr.tolist() == [0, 3, 4]
    assert sweep.src.tolist() == [1, 2, 3, 2]
    assert sweep.w.tolist() == [1.0, 2.0, 3.0, 5.0]


def test_pack_rejects_what_the_kernel_cannot_take():
    dst = np.array([5, 6], np.int32)
    src = np.array([[6, 9], [1, 9]], np.int32)       # row 0 reads node 6,
    w = np.array([[1.0, np.inf], [2.0, np.inf]], np.float32)
    valid = np.array([True, True])
    with pytest.raises(ValueError, match="reads a node"):
        pack_sweep([(dst, src, w, valid)], 10)       # which row 1 writes
    src[0, 0] = 5                                    # a self-loop is fine
    pack_sweep([(dst, src, w, valid)], 10)
    with pytest.raises(ValueError, match="outside"):
        pack_sweep([(dst, src, w, valid)], 6)        # dst 6 >= 6
    # an out-of-range index on a dropped (+inf) slot is never read
    src[0, 1] = 99
    pack_sweep([(dst, src, w, valid)], 10)


@st.composite
def _sweeps(draw):
    s = draw(st.integers(1, 9))
    n = draw(st.integers(20, 400))
    n_levels = draw(st.integers(1, 5))
    m = draw(st.integers(2, 60))
    k = draw(st.integers(1, 8))
    empty = tuple(i for i in range(n_levels) if draw(st.booleans())
                  and draw(st.booleans()))
    return s, n, n_levels, m, k, empty, draw(st.integers(0, 10 ** 6))


@settings(max_examples=60, deadline=None)
@given(_sweeps())
def test_pack_properties(case):
    s, n, n_levels, m, k, empty, seed = case
    dist, levels = plan_like_sweep(s, n, n_levels, m, k, seed, empty)
    sweep = pack_sweep(levels, n + 1)
    _assert_layout(sweep, levels)
    got = relax_sweep_(t(dist.copy()), sweep).numpy()
    np.testing.assert_array_equal(got, relax_levels_np(dist, levels))


@pytest.mark.parametrize("forward", [True, False])
def test_served_sweeps_pack_like_their_plans(forward):
    """A real index's plans (a small grid, the served index's build):
    the packed sweep has the plan's real levels, one row per distinct
    destination a level, every finite slot, and relaxes like the
    bucketed levels."""
    g = T.grid_road_graph(24, seed=0)
    res = T.build_hod_fast(g, T.BuildConfig(max_core_nodes=64,
                                            max_core_edges=4096))
    ix = T.pack_index(g, res, chunk=256, k_cap=16, closure_limit=0,
                      device="cpu")
    plan = ix.plan_f if forward else ix.plan_b
    sweep = _plan_sweep(plan, ix.n_pad, torch.device("cpu"))
    real = np.flatnonzero(plan.level_mask)
    levels = [(plan.dst[i], plan.src_idx[i], plan.w[i], plan.row_valid[i])
              for i in real]
    _assert_layout(sweep, levels)
    assert sweep.level_slots[-1] == int(
        (np.isfinite(plan.w[real]) & plan.row_valid[real][..., None]).sum())
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 30, (ix.n_pad, 5)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.5] = np.inf
    dist[ix.n] = np.inf
    got = relax_sweep_(t(dist.copy()), sweep).numpy()
    np.testing.assert_array_equal(got, relax_levels_np(dist, levels))


# ------------------------------------------------------------ launch plan
@st.composite
def _launches(draw):
    n_levels = draw(st.integers(1, 8))
    rows = draw(st.lists(st.integers(0, 50000), min_size=n_levels,
                         max_size=n_levels))
    longest = draw(st.lists(st.integers(0, 300), min_size=n_levels,
                            max_size=n_levels))
    return (draw(st.integers(1, 300)), draw(st.booleans()), rows, longest,
            draw(st.sampled_from([128, 256, 512, 1024])),
            draw(st.integers(1, 2000)))


@settings(max_examples=300, deadline=None)
@given(_launches())
def test_launch_plan_covers_a_row_and_fits(case):
    n_cols, aligned, rows, longest, threads, resident = case
    per_thread = SLOTS_A_THREAD
    vec, lanes, ways, blocks = plan_sweep_launch(
        n_cols, aligned, rows, longest, threads, resident)
    assert vec == (4 if aligned and n_cols % 4 == 0 else 1)
    assert n_cols % vec == 0
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    loads = n_cols // vec
    assert lanes >= min(loads, 32) and (lanes == 1 or lanes < 2 * loads)
    assert len(ways) == len(rows)
    for k, most in zip(ways, longest):
        assert k & (k - 1) == 0 and lanes * k <= 32
        # enough ways that no thread walks more than per_thread slots,
        # unless a row is a whole warp; never more than that asks
        assert -(-most // k) <= per_thread or lanes * k == 32
        assert k == 1 or -(-most // (k // 2)) > per_thread
    assert 1 <= blocks <= resident
    need = max(r * lanes * k for r, k in zip(rows, ways))
    assert blocks * threads >= need or blocks == resident
    assert (blocks - 1) * threads < need or blocks == 1


def test_launch_plan_at_the_served_shape():
    """S = 32, 16-byte loads: 8 lanes a row (64 rows a block of 512).
    The forward sweep's rows hold at most 5 slots, so no row is split,
    and its widest level (22,394 rows) asks 350 blocks, within 132 SMs x
    4 resident.  The backward sweep's longest rows (59, 47, 44, 32 and 19
    slots) split four ways, 14 slots two ways."""
    f_rows = (22394, 20014, 17221, 15557, 14981, 14084, 13336, 12516)
    f_most = (4, 4, 4, 5, 4, 4, 4, 3)
    assert plan_sweep_launch(32, True, f_rows, f_most, 512,
                             H100_SMS * 4) == (4, 8, (1,) * 8, 350)
    b_rows = (789, 1016, 1403, 1902, 2256, 3339, 5544, 8029)
    b_most = (59, 47, 44, 32, 19, 14, 8, 4)
    assert plan_sweep_launch(32, True, b_rows, b_most, 512, H100_SMS * 4) \
        == (4, 8, (4, 4, 4, 4, 4, 2, 1, 1), 141)
    assert plan_sweep_launch(32, False, f_rows, f_most, 512,
                             H100_SMS * 4) == (1, 32, (1,) * 8, 528)
    assert plan_sweep_launch(7, True, (100,), (3,), 512, 528) == (
        1, 8, (1,), 2)
    assert plan_sweep_launch(128, True, (100,), (40,), 512, 528) == (
        4, 32, (1,), 7)
    with pytest.raises(ValueError):
        plan_sweep_launch(32, True, (), (), 512, 528)


@pytest.mark.parametrize("n_cols,aligned", [(1, True), (7, True),
                                            (32, True), (32, False),
                                            (33, True), (128, True)])
def test_kernel_ways_are_the_plans(n_cols, aligned):
    """The kernel reads a level's ways from ``Sweep.ways`` (the row of
    the launch's lanes); the grid is sized by the plan's.  Both come from
    ``ways_of``, so they agree for every lane count and level, also on
    levels cut out by ``Sweep.level``."""
    _, levels = plan_like_sweep(4, 600, 5, 80, 70, seed=n_cols)
    sweep = pack_sweep(levels, 601)
    assert sweep.ways.dtype == torch.int32 and sweep.ways.shape == (6, 5)
    for j in range(6):
        assert sweep.ways[j].tolist() == [
            ways_of(m, 1 << j) for m in sweep.level_max_slots]
    plan = plan_sweep_launch(n_cols, aligned, sweep.level_widths,
                             sweep.level_max_slots, 512, 528)
    row = plan.lanes.bit_length() - 1
    assert tuple(sweep.ways[row].tolist()) == plan.ways
    assert any(k > 1 for k in plan.ways) or plan.lanes == 32
    for i in range(5):
        assert sweep.level(i).ways[row].tolist() == [plan.ways[i]]
