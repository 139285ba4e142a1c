"""The device's side of a traced run: ``torch.profiler`` (CUPTI) over the
card, and the reduction of its events to busy time, top operations and
idle gaps by what the host was doing.

Only device activity is recorded (kernels, copies, memsets); the host
side comes from the benchmark's own spans, on the profiler's clock
(``time.time_ns``).  Nothing is exported to disk.  An event is
``(name, start_ns, end_ns)``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["DeviceTrace", "clip", "merge", "busy_ns", "top_ops",
           "idle_by_host", "FRONT"]

Event = Tuple[str, int, int]

#: The label of idle time outside every host span: the server's own
#: Python (queues, answer rows, row cache, futures) and the event loop.
FRONT = "server front end and event loop"

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """``torch.profiler`` with CUDA activity only, started and stopped
    around the traffic."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> List[Event]:
        """Stop, and the device's events in start order."""
        self._prof.stop()
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()) or e.is_user_annotation():
                continue
            kind = getattr(e, "activity_type", None)   # newer torch only
            if kind is not None and kind() not in _DEVICE_KINDS:
                continue
            start = int(e.start_ns())
            out.append((e.name(), start, start + int(e.duration_ns())))
        out.sort(key=lambda ev: ev[1])
        return out


def clip(events: Iterable[Event], t0: int, t1: int) -> List[Event]:
    """The events' parts inside ``[t0, t1]``."""
    return [(n, max(a, t0), min(b, t1)) for n, a, b in events
            if b > t0 and a < t1]


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(events: Sequence[Event]) -> int:
    """Time in which some operation ran on the device."""
    return sum(b - a for a, b in merge((a, b) for _, a, b in events))


def top_ops(events: Sequence[Event], k: int = 10) -> List[list]:
    """The ``k`` operation names that took most device time:
    ``[[name, seconds], ...]``."""
    tot: Dict[str, int] = defaultdict(int)
    for n, a, b in events:
        tot[n] += b - a
    return [[n, t / 1e9] for n, t in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _overlap(xs: Sequence[Tuple[int, int]],
             ys: Sequence[Tuple[int, int]]) -> int:
    """Total overlap of two sorted, disjoint interval lists."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_by_host(events: Sequence[Event],
                 spans: Sequence[Tuple[str, int, int]],
                 t0: int, t1: int, k: int = 10
                 ) -> Tuple[List[list], Optional[float]]:
    """Idle device time inside ``[t0, t1]`` by the host span it fell in
    (``[[label, seconds], ...]``, largest first; time in no span is
    :data:`FRONT`), and the share of device busy time that lies inside
    spans labelled ``engine.*``: near 1 when the two clocks agree, since
    the engine's answer comes back by a synchronous copy (``None``
    without busy time)."""
    busy = merge((a, b) for _, a, b in events)
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    by_label: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for label, a, b in spans:
        by_label[label].append((a, b))
    out = {label: _overlap(gaps, merge(iv)) for label, iv in by_label.items()}
    out[FRONT] = sum(b - a for a, b in gaps) - sum(out.values())
    engine = merge(iv for label, ivs in by_label.items()
                   if label.startswith("engine.") for iv in ivs)
    total = sum(b - a for a, b in busy)
    inside = _overlap(busy, engine) / total if total else None
    rows = [[label, t / 1e9] for label, t in
            sorted(out.items(), key=lambda kv: -kv[1]) if t > 0][:k]
    return rows, inside
