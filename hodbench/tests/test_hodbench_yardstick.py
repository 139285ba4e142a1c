"""The frozen ruler and the trace's reduction, against hand counts."""
import types

import numpy as np
import pytest

from hodbench import devtrace, spec, yardstick
from hodbench.tests.support import ROOT

INF = np.inf


def _plan():
    """Two levels, the second a padding level.  Level 0: row 0 relaxes
    node 5 from 1 (w 1) and 2 (w 2); row 1 relaxes 6 from 1 (w 3) and a
    padding slot; row 2 is an invalid row."""
    return types.SimpleNamespace(
        level_mask=np.array([True, False]),
        row_valid=np.array([[True, True, False], [True, False, False]]),
        dst=np.array([[5, 6, 7], [8, 9, 9]]),
        src_idx=np.array([[[1, 2], [1, 9], [0, 0]],
                          [[3, 4], [9, 9], [9, 9]]]),
        w=np.array([[[1.0, 2.0], [3.0, INF], [4.0, 4.0]],
                    [[1.0, 1.0], [INF, INF], [INF, INF]]]))


def test_sweep_cost_by_hand():
    # 3 real arcs; nodes touched {1, 2, 5, 6}; written {5, 6}; S = 4
    nbytes, ops = yardstick.sweep_cost(_plan(), 4)
    assert nbytes == 12 * 3 + 4 * 4 * (4 + 2)
    assert ops == 2 * 4 * 3


def test_minplus_cost_and_bound_by_hand():
    assert yardstick.minplus_cost(2, 3) == (4 * (6 + 9 + 6), 2 * 2 * 9)
    peak = yardstick.PEAK
    assert yardstick.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    ops = peak["simt_ops_per_s"] * 2
    assert yardstick.bound_s(1.0, ops) == pytest.approx(2.0)
    assert peak["simt_ops_per_s"] == pytest.approx(132 * 128 * 1.98e9)


def test_trace_reduction_by_hand():
    ev = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 60, 70)]
    assert devtrace.clip(ev, 0, 50) == ev[:3]
    assert devtrace.busy_ns(devtrace.clip(ev, 0, 50)) == 30
    assert devtrace.top_ops(ev) == [["a", 20e-9], ["b", 15e-9],
                                    ["c", 10e-9]]
    spans = [("engine.ssd", 0, 35), ("clients", 45, 50)]
    rows, inside = devtrace.idle_by_host(ev[:3], spans, 0, 50)
    assert sorted(rows) == sorted([["engine.ssd", 10e-9],
                                   ["clients", 5e-9],
                                   [devtrace.FRONT, 5e-9]])
    assert inside == pytest.approx(25 / 30)


def _reader(name):
    return spec.load_module(ROOT / "hodbench" / "metrics" / f"{name}.py")


def _ctx(events):
    plan = _plan()
    return types.SimpleNamespace(
        events=events, trace_window_s=1e-6, batch_size=4,
        stats0={"batches": 10, "busy_seconds": 1.0},
        stats1={"batches": 12, "busy_seconds": 1.5},
        window_s=0.7, answered=100, latencies=np.array([0.001, 0.002]),
        index=types.SimpleNamespace(n_core=3, plan_f=plan, plan_b=plan))


def test_readers_by_hand():
    ev = [("minplus_kernel", 0, 400), ("minplus_combine_kernel", 400, 500),
          ("relax_sweep_kernel", 500, 600),
          ("Memcpy DtoH (Device -> Pageable)", 600, 1000)]
    ctx = _ctx(ev)
    mp = yardstick.bound_s(*yardstick.minplus_cost(4, 3))
    assert _reader("tropical_matmul_roofline").read(ctx) == \
        pytest.approx(100 * 2 * mp / 500e-9)
    sw = 2 * yardstick.bound_s(*yardstick.sweep_cost(_plan(), 4))
    assert _reader("edge_relax_roofline").read(ctx) == \
        pytest.approx(100 * 2 * sw / 100e-9)
    assert _reader("d2h_ms_per_batch").read(ctx) == pytest.approx(400e-6 / 2)
    assert _reader("idle_share").read(ctx) == pytest.approx(0.0)
    assert _reader("engine_ms_per_batch").read(ctx) == pytest.approx(250.0)
    assert _reader("frontend_ms_per_batch").read(ctx) == pytest.approx(100.0)
    assert _reader("qps").read(ctx) == pytest.approx(100 / 0.7)


@pytest.mark.parametrize("name", ["tropical_matmul_roofline",
                                  "edge_relax_roofline", "d2h_ms_per_batch",
                                  "idle_share"])
def test_device_readers_read_nothing_without_a_trace(name):
    assert _reader(name).read(_ctx(None)) is None
    if name != "idle_share":    # another kernel is not this one's work
        assert _reader(name).read(_ctx([("other_kernel", 0, 5)])) is None
