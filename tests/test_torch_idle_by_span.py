"""``tools/idle_by_span.py``: a device's idle time put down to the
innermost host span that covers it, on hand-made events and spans and
on a real ``Tracer``'s spans mapped onto the wall clock."""
import importlib.util
import threading
import time
from pathlib import Path

import pytest

from repro_torch.obs import Tracer

_spec = importlib.util.spec_from_file_location(
    "idle_by_span",
    Path(__file__).resolve().parent.parent / "tools" / "idle_by_span.py")
ibs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ibs)


def test_idle_goes_to_the_innermost_span():
    """Nested and disjoint spans, one reaching past the window and one
    outside it; the rows sum to the window's idle time."""
    events = [("k", 10, 20), ("DtoH", 50, 60), ("k", 55, 58)]
    spans = [("a", 0, 40), ("b", 5, 30), ("c", 45, 90), ("d", 70, 80),
             ("e", 95, 120), ("outside", 130, 140)]
    got = ibs.idle_by_innermost(events, spans, 0, 100)
    assert got == {"a": 15, "b": 15, "c": 25, "d": 10, "e": 5,
                   ibs.FRONT: 10}
    assert sum(got.values()) == 100 - 20


@pytest.mark.parametrize("order", [1, -1])
def test_of_two_spans_with_one_start_the_shorter_is_inner(order):
    spans = [("p", 0, 10), ("q", 0, 4)][::order]
    assert ibs.idle_by_innermost([], spans, 0, 10) == {"q": 4, "p": 6}


def test_host_spans_of_a_tracer_on_the_wall_clock():
    """One thread's B/E spans, mapped by ``to_epoch_ns``; an ``X`` span
    (a wait, not host work) and another thread's spans take no part, so
    idle time under the wait alone stays the front end's."""
    tr = Tracer()
    a = time.time_ns()
    with tr.span("jit.dispatch"):
        with tr.span("phase.core"):
            time.sleep(0.002)
    waited = tr.now()
    time.sleep(0.001)
    tr.complete("coalesce.wait", waited)

    def elsewhere():
        with tr.span("other"):
            time.sleep(0.001)
    t = threading.Thread(target=elsewhere, name="elsewhere")
    with tr.span("server.rows"):
        t.start()
        t.join()
    b = time.time_ns()
    assert "other" in {s["name"] for s in tr.spans()}
    spans = ibs.host_spans(tr, threading.current_thread().name)
    assert [s[0] for s in spans] == ["phase.core", "jit.dispatch",
                                     "server.rows"]
    assert all(a <= s0 < s1 <= b for _, s0, s1 in spans)
    got = ibs.idle_by_innermost([], spans, a, b)
    assert set(got) == {"phase.core", "jit.dispatch", "server.rows",
                        ibs.FRONT}
    assert got["phase.core"] >= 2_000_000 and got[ibs.FRONT] >= 1_000_000
    assert sum(got.values()) == b - a
