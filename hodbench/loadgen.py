"""The one traffic generator.  A mix file (``traffic/<name>.json``) sets
its parameters; nothing here knows a mix by name.

Keys of a mix:

* ``mode``: the query the server answers (``ssd`` or ``sssp``);
* ``sources``: ``{"dist": "uniform"}`` over all nodes;
* ``loop``: ``closed`` with ``clients`` asyncio tasks, each submitting
  again as soon as it has its answer;
* ``warmup_seconds``: traffic before the window opens (set-up);
* ``checked_rows``: answers kept, uniformly over the window's, for the
  comparison with the reference.

The window is measured inside one run of the traffic, so it opens on a
steady state: no ramp, the row cache as the traffic leaves it.
"""
from __future__ import annotations

import asyncio
import collections
import random
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["draw_sources", "Drive"]

#: Sources drawn ahead of a run; submissions take them in order, and wrap.
POOL = 1 << 20


def draw_sources(spec: dict, n: int, rng: np.random.Generator,
                 count: int = POOL) -> np.ndarray:
    """``count`` source nodes in submission order, by ``spec``."""
    if spec["dist"] != "uniform":
        raise ValueError(f"unknown source distribution {spec['dist']!r}")
    return rng.integers(0, n, size=count, dtype=np.int64)


def _snapshot(stats) -> Dict[str, float]:
    return dict(vars(stats))


class Drive:
    """One run of a mix against a server: warm-up, the window, the drain.

    After :meth:`run`, ``latencies`` holds the submit-to-answer seconds of
    every request submitted in the window and answered, ``answered`` the
    answers received inside the window, ``attempted`` and ``failed`` the
    window's requests and those that failed or never came, ``kept`` the
    ``(source, QueryResult)`` sample, ``per_second`` the answers in each
    second of the window, ``stats0``/``stats1`` the server's
    ``ServerStats`` at the window's two ends, ``w0``/``w1`` its ends on
    the host clock (``perf_counter``) and ``w0_ns``/``w1_ns`` on the
    profiler's (``time.time_ns``).  With ``spans`` (a list), each closed-
    loop client's own bookkeeping after an answer is appended as
    ``("clients", t0_ns, t1_ns)``.
    """

    def __init__(self, server, mix: dict, sources: np.ndarray, seed: int,
                 spans: Optional[list] = None):
        self.server, self.mix, self.sources = server, mix, sources
        self.mode = mix["mode"]
        self.want = int(mix["checked_rows"])
        self._rnd = random.Random(seed)
        self._spans = spans
        self._next = 0
        self.w0 = self.w1 = None
        self.w0_ns = self.w1_ns = None
        self.stats0 = self.stats1 = None
        self.latencies: List[float] = []
        self.answered = self.attempted = self.failed = 0
        self.errors: List[str] = []
        self.per_second = collections.Counter()
        self.kept: list = []
        self._stop = asyncio.Event()

    # ------------------------------------------------------------ window
    def _open(self) -> None:
        self.w0, self.w0_ns = time.perf_counter(), time.time_ns()
        self.stats0 = _snapshot(self.server.stats)

    def _close(self) -> None:
        self.w1, self.w1_ns = time.perf_counter(), time.time_ns()
        self.stats1 = _snapshot(self.server.stats)
        self._stop.set()

    def _in_window(self, t: float) -> bool:
        return self.w0 is not None and t >= self.w0 \
            and (self.w1 is None or t < self.w1)

    def _source(self) -> int:
        src = int(self.sources[self._next % self.sources.shape[0]])
        self._next += 1
        return src

    # ---------------------------------------------------------- requests
    async def _one(self, src: int):
        """Submit one request and account for it; returns when the answer
        came (``time.time_ns``) and whether it came without the request
        waiting for a batch."""
        t0 = time.perf_counter()
        counted = self._in_window(t0)
        self.attempted += counted
        try:
            res = await self.server.submit(src, mode=self.mode)
        except Exception as exc:            # a failed answer is counted
            if counted and len(self.errors) < 5:
                self.errors.append(repr(exc))
            return time.time_ns(), True
        t1 = time.perf_counter()
        back = time.time_ns()
        if self._in_window(t1):
            self.answered += 1
            self.per_second[int(t1 - self.w0)] += 1
        if counted:
            self.latencies.append(t1 - t0)
            if len(self.kept) < self.want:
                self.kept.append((src, res))
            else:
                j = self._rnd.randrange(len(self.latencies))
                if j < self.want:
                    self.kept[j] = (src, res)
        return back, getattr(res, "cached", True)

    async def _client(self) -> None:
        while not self._stop.is_set():
            back, at_once = await self._one(self._source())
            if self._spans is not None:
                self._spans.append(("clients", back, time.time_ns()))
            if at_once:
                # A row-cache hit answers without suspending: let the
                # loop run the window's timers and the other clients.
                await asyncio.sleep(0)

    async def run(self, warm_s: float, seconds: float,
                  drain_s: float = 60.0) -> None:
        """Traffic for ``warm_s``, then the window of ``seconds``, then
        stop submitting and wait up to ``drain_s`` for every answer due:
        one that never comes counts as failed."""
        loop = asyncio.get_running_loop()
        loop.call_later(warm_s, self._open)
        loop.call_later(warm_s + seconds, self._close)
        if self.mix["loop"] != "closed":
            raise ValueError(f"unknown loop {self.mix['loop']!r}")
        drivers = [asyncio.create_task(self._client())
                   for _ in range(int(self.mix["clients"]))]
        await self._stop.wait()
        done, pending = await asyncio.wait(drivers, timeout=drain_s)
        for t in done:
            t.result()
        if pending:
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
        self.failed = self.attempted - len(self.latencies)
