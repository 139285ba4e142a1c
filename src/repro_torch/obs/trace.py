"""Query tracing: nestable spans + instants, Chrome-trace export
(DESIGN.md §11).

The JAX package's ``obs/trace.py``, copied so that the port needs
nothing of that package; a trace of either package's server has the
same span names, tracks and attributes, so the two line up in one
viewer.  The port adds spans of its own on the in-memory path and in
the front end (below), and a clock mapping.

The serving stack's argument is I/O *attribution* — which reads a
query caused, which it avoided, and how far the pipeline hid the rest
behind compute.  Aggregate counters (``IOStats`` / ``CacheStats`` /
``PipelineStats``) answer that for a workload; the :class:`Tracer`
answers it for one query: every served batch opens a root span
(``query.ssd``, ``query.p2p``, …) whose children cover coalesce-wait,
the dispatch, and — per streamed level — the submit-side cache
transaction, the io-thread pread, the decode-pool frame decode, and
the query-thread reap/relax.  Exported as Chrome trace-event JSON
(open in https://ui.perfetto.dev) plus a flat JSONL event log.

**Tracks.** Chrome traces group events by thread id, and B/E spans
must nest *per thread*.  Events land on three kinds of tracks:

* the real thread that emitted them (query thread, ``hod-pipe-io``,
  ``hod-pipe-decode_*``) — the default, giving balanced nesting per
  thread and making read/decode/relax **overlap visible** as
  simultaneous spans on different rows of the timeline;
* a named *synthetic* track (``track="submit"`` …) for events whose
  emission point is pipelined but whose *order* is the deterministic
  submit order — ``pipe.submit`` spans and the cache hit/miss/evict
  instants fired inside them.  Keeping these off the query thread's
  track is what makes the query-thread span sequence identical at
  every queue depth;
* retroactive ``"X"`` complete events (:meth:`complete`) for
  durations only measurable after the fact (``coalesce.wait``).

**The port's in-memory spans.**  Inside ``jit.dispatch`` the in-memory
``QueryEngine`` opens one span a phase a batch: ``phase.forward`` (the
label state and the forward sweep), ``phase.core`` (the core search),
``phase.backward`` (the backward sweep), ``phase.recon`` (SSSP's three
reconstruction plans) and ``phase.to_host`` (one an answer copied,
``what="dist"`` or ``"pred"``; each copies the padded batch's ``[S_pad,
n]`` answer, so its bytes follow from the server's batch size and the
graph).  The front end opens ``server.rows`` (the answer rows copied
and put in the row cache) and ``server.resolve`` (the requests'
latencies observed and their futures resolved).  None of these fires
on the store-backed path, whose query-thread sequence is the JAX
package's::

    coalesce.wait (X, async path: the oldest rider's wait)
    query.sssp
      jit.dispatch
        phase.forward, phase.core, phase.backward, phase.recon
        phase.to_host (what="dist"), phase.to_host (what="pred")
    server.rows
    server.resolve (async path)

(an SSD batch has no ``phase.recon`` and one ``phase.to_host``).

**One clock with the device's.**  Timestamps count nanoseconds of
``time.perf_counter_ns`` from the tracer's construction, where it reads
``time.time_ns`` once (:attr:`Tracer.epoch_ns`) between two readings of
the counter, whose midpoint is the origin.  :meth:`Tracer.to_epoch_ns`
adds that reading, which puts a timestamp on the clock
``torch.profiler``'s device events carry; ``chrome()`` writes it under
``otherData``.  The mapping assumes that the wall clock is not stepped
while the tracer lives.

**Stitching.** Work that hops threads carries an explicit span id:
``Tracer.new_id()`` at submit, then every related event (the io
thread's ``level.read``, each decode worker's ``level.decode``, the
reaper's ``level.wait``) repeats it as a ``span``/``parent`` attr —
Perfetto's query view joins them back into one per-level story.

**Overhead.** A ``None`` tracer is the off switch — every hook site
guards with ``if tracer is not None`` (or :func:`span_if`), so disabled
tracing adds one attribute load per site.  Enabled tracing buffers flat
tuples in memory with a lock-free append (atomic under the GIL).  Its
measured cost on the port's served path (an H100, the in-memory road
grid of 40,000 nodes under 128 closed-loop SSD clients, 17 events a
batch of 32): 0.7% and 2.9% of the untraced q/s in two sets, each the
medians of six alternating 8-s windows a side (PERF.md §6).
Tracing never changes answers or counter sequences: hooks only
*observe*.  No hook synchronizes the card: a span's end is when the
host returns, which for the server's ``jit.dispatch`` is after the
answer's copy to the host.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "span_if", "validate_chrome_trace"]


class _Span:
    """Context manager emitting a B/E pair on the tracer."""

    __slots__ = ("_tracer", "name", "track", "attrs")

    def __init__(self, tracer: "Tracer", name: str,
                 track: Optional[str], attrs: dict):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self._tracer._emit("B", self.name, self.track, self.attrs)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._emit("E", self.name, self.track, None)
        return False


def span_if(tracer: Optional["Tracer"], name: str,
            track: Optional[str] = None, **attrs):
    """``tracer.span(...)`` or an inert context when tracing is off —
    the one-liner hook sites use so disabled tracing stays a no-op."""
    if tracer is None:
        return nullcontext()
    return tracer.span(name, track=track, **attrs)


class Tracer:
    """Append-only trace buffer with span/instant emission.

    Timestamps are ``time.perf_counter_ns`` relative to construction
    (exported as microseconds, the Chrome trace unit);
    :meth:`to_epoch_ns` maps one onto ``time.time_ns``.  All methods
    are thread-safe; events record which real thread (or synthetic
    ``track``) emitted them.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Internal buffer holds flat tuples, not dicts: (ph, name, ts,
        # tkey, tname, attrs, dur).  Appending one object to a list is
        # atomic under the GIL, so the hot path takes no lock and
        # builds no dict — that is what keeps enabled tracing cheap
        # (its measured cost is in the module docstring); events()
        # materializes dicts.
        self._events: List[tuple] = []
        self._next_id = 0
        before = time.perf_counter_ns()
        #: ``time.time_ns()`` at the origin of the timestamps.
        self.epoch_ns = time.time_ns()
        self._t0 = (before + time.perf_counter_ns()) // 2

    # ------------------------------------------------------------- emission
    def now(self) -> int:
        """Nanoseconds since tracer start (for :meth:`complete`)."""
        return time.perf_counter_ns() - self._t0

    def to_epoch_ns(self, ts: int) -> int:
        """A timestamp of this tracer's on the ``time.time_ns`` clock
        (``torch.profiler``'s)."""
        return self.epoch_ns + ts

    def new_id(self) -> int:
        """Fresh span id for cross-thread stitching (ticket attrs)."""
        with self._lock:
            self._next_id += 1
            return self._next_id

    def _emit(self, ph: str, name: str, track: Optional[str],
              attrs: Optional[dict], ts_ns: Optional[int] = None,
              dur_ns: Optional[int] = None) -> None:
        ts = (time.perf_counter_ns() - self._t0) if ts_ns is None \
            else ts_ns
        if track is None:
            th = threading.current_thread()
            tkey: Tuple = ("thread", th.ident)
            tname = th.name
        else:
            tkey, tname = ("track", track), track
        self._events.append((ph, name, ts, tkey, tname, attrs, dur_ns))

    def span(self, name: str, track: Optional[str] = None,
             **attrs) -> _Span:
        """Nestable span (``with tracer.span("level.relax", level=3):``).
        Spans on one thread/track must nest — that is the Chrome B/E
        contract the validator enforces."""
        return _Span(self, name, track, attrs)

    def instant(self, name: str, track: Optional[str] = None,
                **attrs) -> None:
        """Zero-duration event (cache hit/miss/evict, device access)."""
        self._emit("i", name, track, attrs)

    def complete(self, name: str, start_ns: int,
                 track: Optional[str] = None, **attrs) -> None:
        """Retroactive span: ``start_ns`` from an earlier :meth:`now`
        call, duration until now (``coalesce.wait`` — the wait is only
        known once the batch flushes).  ``"X"`` events carry their own
        duration, so they need no nesting discipline."""
        end = self.now()
        self._emit("X", name, track, attrs, ts_ns=start_ns,
                   dur_ns=max(0, end - start_ns))

    def clear(self) -> None:
        """Drop buffered events (server warmup: compile-time spans must
        not pollute the served trace)."""
        self._events.clear()

    # -------------------------------------------------------------- reading
    def events(self) -> List[dict]:
        """Snapshot of the raw internal events (ns timestamps)."""
        out: List[dict] = []
        for ph, name, ts, tkey, tname, attrs, dur in self._events[:]:
            e = {"ph": ph, "name": name, "ts": ts,
                 "tkey": tkey, "tname": tname}
            if attrs:
                e["args"] = attrs
            if dur is not None:
                e["dur"] = dur
            out.append(e)
        return out

    def sequence(self, where: str) -> List[tuple]:
        """The deterministic shape of one track: ``(ph, name, attrs)``
        tuples for every event whose thread/track name is ``where``,
        timestamps and durations excluded.  This is what the
        cross-depth determinism tests compare — identical queries must
        yield identical sequences at every queue depth."""
        out = []
        for e in self.events():
            if e["tname"] != where:
                continue
            attrs = tuple(sorted((e.get("args") or {}).items()))
            out.append((e["ph"], e["name"], attrs))
        return out

    def spans(self) -> List[dict]:
        """Materialized intervals: B/E pairs (stack-matched per track)
        and X events as ``{"name", "tname", "t0", "t1", "args", "ph"}``
        with ns bounds and ``ph`` ``"B"`` for a pair, ``"X"`` for a
        complete event — what the overlap checks consume."""
        out: List[dict] = []
        stacks: Dict[tuple, list] = {}
        for e in sorted(self.events(), key=lambda e: e["ts"]):
            if e["ph"] == "B":
                stacks.setdefault(e["tkey"], []).append(e)
            elif e["ph"] == "E":
                stack = stacks.get(e["tkey"])
                if stack:
                    b = stack.pop()
                    out.append({"name": b["name"], "tname": b["tname"],
                                "t0": b["ts"], "t1": e["ts"],
                                "args": b.get("args") or {}, "ph": "B"})
            elif e["ph"] == "X":
                out.append({"name": e["name"], "tname": e["tname"],
                            "t0": e["ts"], "t1": e["ts"] + e["dur"],
                            "args": e.get("args") or {}, "ph": "X"})
        return out

    # -------------------------------------------------------------- export
    def chrome(self) -> dict:
        """Chrome trace-event document (Perfetto-loadable).

        Events are globally sorted by timestamp (stable, so same-thread
        order is preserved) and threads/tracks get small stable tids
        with ``thread_name`` metadata.  Timestamps are microseconds;
        ``otherData.epoch_ns`` is :attr:`epoch_ns`, the ``time.time_ns``
        of timestamp 0.
        """
        evs = sorted(self.events(), key=lambda e: e["ts"])
        tids: Dict[tuple, int] = {}
        meta: List[dict] = []
        out: List[dict] = []
        for e in evs:
            tid = tids.get(e["tkey"])
            if tid is None:
                tid = tids[e["tkey"]] = len(tids) + 1
                meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                             "tid": tid, "args": {"name": e["tname"]}})
            ev = {"name": e["name"], "ph": e["ph"], "pid": 1,
                  "tid": tid, "ts": e["ts"] / 1e3}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] / 1e3
            elif e["ph"] == "i":
                ev["s"] = "t"           # instant scope: thread
            if e.get("args"):
                ev["args"] = e["args"]
            out.append(ev)
        return {"traceEvents": meta + out, "displayTimeUnit": "ms",
                "otherData": {"epoch_ns": self.epoch_ns}}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome(), f)
            f.write("\n")

    def write_jsonl(self, path: str) -> None:
        """Flat event log, one JSON object per line (ns timestamps) —
        the grep/jq-friendly twin of the Chrome export."""
        with open(path, "w") as f:
            for e in self.events():
                e = dict(e)
                e["tkey"] = list(e["tkey"])
                f.write(json.dumps(e) + "\n")


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema problems in a Chrome trace-event document (empty = valid).

    Checks what Perfetto's importer relies on: every event carries
    ``name/ph/ts/pid/tid``; per ``(pid, tid)`` timestamps are
    monotonically non-decreasing, ``B``/``E`` pairs are balanced and
    properly nested (matching names), and no ``E`` arrives without an
    open ``B``.  Used by the CI smoke step on the traced-serve
    artifact.
    """
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[tuple, list] = {}
    last_ts: Dict[tuple, float] = {}
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph == "M":
            continue
        missing = [f for f in ("name", "ph", "ts", "pid", "tid")
                   if f not in e]
        if missing:
            problems.append(f"event {i}: missing field(s) {missing}")
            continue
        tid = (e["pid"], e["tid"])
        if e["ts"] < last_ts.get(tid, float("-inf")):
            problems.append(f"event {i} ({e['name']!r}): ts "
                            f"{e['ts']} goes backwards on tid {e['tid']}")
        last_ts[tid] = e["ts"]
        if ph == "B":
            stacks.setdefault(tid, []).append(e["name"])
        elif ph == "E":
            stack = stacks.get(tid)
            if not stack:
                problems.append(f"event {i} ({e['name']!r}): E without "
                                f"matching B on tid {e['tid']}")
            elif stack[-1] != e["name"]:
                problems.append(f"event {i}: E {e['name']!r} closes "
                                f"B {stack[-1]!r} on tid {e['tid']}")
                stack.pop()
            else:
                stack.pop()
        elif ph == "X" and "dur" not in e:
            problems.append(f"event {i} ({e['name']!r}): X without dur")
    for tid, stack in stacks.items():
        if stack:
            problems.append(f"tid {tid[1]}: unbalanced B events "
                            f"left open: {stack}")
    return problems
