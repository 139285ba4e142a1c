"""The plain reference and the comparison: distances against a
brute-force Floyd-Warshall, predecessors against the tree property."""
import numpy as np
import pytest
import torch

from hodbench import verdict
from hodbench.reference import ArcTable, shortest_distances


def _floyd(n, src, dst, w):
    d = np.full((n, n), np.inf)
    np.fill_diagonal(d, 0.0)
    for u, v, x in zip(src, dst, w):
        d[u, v] = min(d[u, v], x)
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


def _graph(seed, n=30, m=70):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.integers(1, 10001, m).astype(np.float64)
    # a parallel arc and a self loop, which must not change anything
    return n, np.r_[src, src[0], 3], np.r_[dst, dst[0], 3], \
        np.r_[w, w[0] + 5, 1.0]


@pytest.mark.parametrize("seed", range(6))
def test_reference_equals_floyd_warshall(seed):
    n, src, dst, w = _graph(seed)
    want = _floyd(n, src, dst, w)
    got = shortest_distances(n, src, dst, w, np.arange(n), block=7,
                             check_every=2)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(want).any()          # some nodes are unreachable


def test_arc_table_takes_the_shortest_parallel_arc():
    t = ArcTable(4, np.array([0, 0, 1]), np.array([1, 1, 2]),
                 np.array([5.0, 3.0, 2.0]))
    np.testing.assert_array_equal(t.weight(np.array([0, 1, 2]),
                                           np.array([1, 2, 0])),
                                  [3.0, 2.0, np.nan])


def test_dist_errors():
    ref = np.array([[0.0, 4.0, np.inf]])
    assert verdict.dist_errors(ref, ref.astype(np.float32)) == \
        {"wrong_dist": 0, "max_dist_err": 0.0}
    got = np.array([[0.0, 5.0, 7.0]], np.float32)
    assert verdict.dist_errors(ref, got) == \
        {"wrong_dist": 2, "max_dist_err": np.inf}


def test_pred_errors():
    # 0 -> 1 (2), 1 -> 2 (3), 0 -> 2 (9): the tree from 0 is 0 -> 1 -> 2
    arcs = ArcTable(4, np.array([0, 1, 0]), np.array([1, 2, 2]),
                    np.array([2.0, 3.0, 9.0]))
    ref = np.array([[0.0, 2.0, 5.0, np.inf]])
    src = np.array([0])
    assert verdict.pred_errors(ref, np.array([[-1, 0, 1, -1]]), src,
                               arcs) == 0
    for bad in ([-1, 0, 0, -1],      # an arc, but not a tight one
                [0, 0, 1, -1],       # the source has a predecessor
                [-1, 0, 1, 2],       # an unreachable node has one
                [-1, 0, -1, -1],     # a reachable node has none
                [-1, 2, 1, -1]):     # no arc 2 -> 1
        assert verdict.pred_errors(ref, np.array([bad]), src, arcs) == 1


def test_judge():
    ok, checks = verdict.judge({"wrong_dist": 0, "max_dist_err": 0.0,
                                "failed": 0, "rows_checked": 8}, 8)
    assert ok and checks["wrong_dist"] == {"value": 0, "limit": 0}
    assert not verdict.judge({"wrong_dist": 1, "failed": 0,
                              "rows_checked": 8}, 8)[0]
    assert not verdict.judge({"wrong_dist": 0, "failed": 0,
                              "rows_checked": 7}, 8)[0]
    assert not verdict.judge({"wrong_dist": 0, "failed": 1,
                              "rows_checked": 8}, 8)[0]


def test_bfloat16_control_fails_the_comparison():
    """The control (the reference in bfloat16, one precision below the
    configurations' float32) at a test's size: weights up to 10,000 are
    not bfloat16 numbers, so it reads far above the limit 0."""
    n, src, dst, w = _graph(11, n=60, m=240)
    ref = shortest_distances(n, src, dst, w, np.arange(8))
    low = shortest_distances(n, src, dst, w, np.arange(8),
                             dtype=torch.bfloat16)
    got = verdict.check_rows(ref, low, np.arange(8))
    assert got["wrong_dist"] > 0 and got["max_dist_err"] > 0
    assert not verdict.judge(dict(got, failed=0), 8)[0]
