"""Metrics: counters, gauges, fixed-bucket histograms (DESIGN.md §11).

The serving layer needs per-class latency percentiles (the SLO
scheduler's currency) without keeping a per-request list: a
:class:`Histogram` counts observations into *fixed* log-spaced buckets
and reads p50/p95/p99 back by linear interpolation inside the
straddling bucket — O(buckets) memory forever, error bounded by one
bucket's width (the bounds grow by ``2**0.5`` per bucket, so a
percentile is off by at most ~19% of its value; DESIGN.md §11 states
the policy).

A :class:`MetricsRegistry` names the instruments and snapshots them
all as one JSON-able dict stamped with :data:`SCHEMA_VERSION` — the
same version ``benchmarks/run.py`` writes into BENCH_serve.json so
``check_regression.py`` can fail loudly on schema drift instead of
KeyError-ing.  The registry subsumes the ad-hoc ``ServerStats``
arithmetic: every server counter lands here too, plus the derived
rates, so ``--metrics-out`` is the one machine-readable summary of a
serving run.

Zero dependencies, thread-safe (one lock per instrument), and cheap
enough for per-request hot paths: an observe is a bisect + two adds.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["SCHEMA_VERSION", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "exp_buckets"]

#: Version of the metrics-snapshot / BENCH row schema.  Bump when a
#: snapshot or bench table changes shape incompatibly;
#: ``check_regression.py`` refuses to compare mismatched versions.
#: v2: BENCH_serve.json gained the ``slo`` table.
#: v3: BENCH_serve.json gained the ``fleet`` table.
SCHEMA_VERSION = 3


def exp_buckets(lo: float = 0.05, hi: float = 60_000.0,
                factor: float = 2 ** 0.5) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi] (inclusive of
    one bound past ``hi``).  The default spans 50µs–60s in ms units at
    √2 spacing — 42 buckets, good for sub-20% percentile error across
    six decades of latency."""
    if not (lo > 0 and hi > lo and factor > 1):
        raise ValueError("need 0 < lo < hi and factor > 1")
    bounds: List[float] = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * factor)
    return tuple(bounds)


#: Default latency bucket bounds, in milliseconds.
LATENCY_BUCKETS_MS = exp_buckets()


class Counter:
    """Monotonic float counter."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins value (queue depth, hit rate, …)."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with percentile read-back.

    ``bounds`` are ascending bucket *upper* bounds; one implicit
    overflow bucket catches everything past the last bound.  No
    per-observation state is kept.
    """

    __slots__ = ("_lock", "bounds", "counts", "count", "total")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS_MS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise ValueError("bounds must be non-empty and ascending")
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # [+overflow]
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += v

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` (0–1), interpolated linearly inside
        the straddling bucket; the overflow bucket reports the last
        bound (a floor — the true value is larger).  0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            cum = 0.0
            for i, c in enumerate(self.counts):
                if cum + c >= target and c > 0:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    if i >= len(self.bounds):
                        return self.bounds[-1]
                    frac = (target - cum) / c
                    return lo + frac * (self.bounds[i] - lo)
                cum += c
            return self.bounds[-1]

    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean(),
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Named instruments + one-dict JSON snapshot.

    ``counter``/``gauge``/``histogram`` create-or-fetch by name (a
    name that exists with a different type is an error — silent
    shadowing would corrupt the snapshot).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is {type(inst).__name__}, "
                    f"not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(bounds or LATENCY_BUCKETS_MS))

    def histograms(self, prefix: str = "") -> Dict[str, Histogram]:
        """All histograms whose name starts with ``prefix``."""
        with self._lock:
            return {k: v for k, v in self._instruments.items()
                    if isinstance(v, Histogram) and k.startswith(prefix)}

    def snapshot(self) -> dict:
        """One JSON-able dict of everything, schema-versioned."""
        out = {"schema_version": SCHEMA_VERSION, "counters": {},
               "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._instruments.items())
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                h = inst.summary()
                h["bounds"] = list(inst.bounds)
                h["bucket_counts"] = list(inst.counts)
                out["histograms"][name] = h
        return out

    def reset(self) -> None:
        """Zero every instrument in place (server warmup), keeping the
        registered names and histogram bucket bounds."""
        with self._lock:
            items = list(self._instruments.items())
        for _, inst in items:
            if isinstance(inst, (Counter, Gauge)):
                with inst._lock:
                    inst.value = 0.0
            else:
                with inst._lock:
                    inst.counts = [0] * (len(inst.bounds) + 1)
                    inst.count = 0
                    inst.total = 0.0
