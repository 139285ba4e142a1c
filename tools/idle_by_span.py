"""Put a device's idle time down to the host span that holds it.

For a harness that records the device with ``torch.profiler`` and the
served path with the program's own ``repro_torch.obs.Tracer``:

* :func:`host_spans` gives one thread's B/E spans of a tracer as
  ``(name, start, end)`` on the profiler's clock
  (``Tracer.to_epoch_ns``).  ``X`` spans such as ``coalesce.wait`` are
  waiting, not host work, and are left out;
* :func:`idle_by_innermost` takes the device's events and such spans
  (a harness may add its own, on the same clock) and returns the idle
  time of a window by the innermost span that covers it, and
  :data:`FRONT` under none.  The rows sum to the window's idle time.

    from idle_by_span import host_spans, idle_by_innermost
    rows = idle_by_innermost(events, host_spans(tracer, thread), w0, w1)
"""
import heapq
from collections import defaultdict

__all__ = ["FRONT", "host_spans", "idle_by_innermost"]

#: Idle time under no span: the server's front end and the event loop.
FRONT = "server front end and event loop"


def host_spans(tracer, thread: str) -> list:
    """``tracer``'s B/E spans on ``thread`` as ``(name, start, end)``,
    in nanoseconds of ``time.time_ns``."""
    return [(s["name"], tracer.to_epoch_ns(s["t0"]),
             tracer.to_epoch_ns(s["t1"]))
            for s in tracer.spans() if s["tname"] == thread
            and s["ph"] == "B"]


def _busy(events, t0: int, t1: int) -> list:
    """The union of the events' ``(name, start, end)`` inside
    ``[t0, t1]``, as sorted disjoint ``[start, end]``."""
    out = []
    for a, b in sorted((max(a, t0), min(b, t1)) for _, a, b in events
                       if b > t0 and a < t1):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_innermost(events, spans, t0: int, t1: int) -> dict:
    """Idle device time inside ``[t0, t1]`` (ns) by the innermost of
    ``spans`` (``(label, start, end)``, nested or disjoint) that covers
    it, :data:`FRONT` under none.  ``events`` are the device's
    ``(name, start, end)``.  Innermost is the latest start; of two with
    one start, the shorter."""
    gaps, at = [], t0
    for a, b in _busy(events, t0, t1):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    spans = sorted((a, -b, label) for label, a, b in spans
                   if b > a and b > t0 and a < t1)
    cuts = sorted({x for g in gaps for x in g}
                  | {x for a, nb, _ in spans for x in (a, -nb)})
    out = defaultdict(int)
    live, si, gi = [], 0, 0
    for x, y in zip(cuts, cuts[1:]):
        while si < len(spans) and spans[si][0] <= x:
            a, nb, label = spans[si]
            heapq.heappush(live, (-a, -si, -nb, label))
            si += 1
        while live and live[0][2] <= x:
            heapq.heappop(live)
        while gi < len(gaps) and gaps[gi][1] <= x:
            gi += 1
        if gi < len(gaps) and gaps[gi][0] <= x:
            out[live[0][3] if live else FRONT] += y - x
    return dict(out)
