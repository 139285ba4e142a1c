"""Batched HoD query serving on PyTorch (DESIGN.md §8, §12): async
request coalescing, fixed batch shapes, an LRU source-row cache, a
mixed-traffic SLO scheduler, tracing, and disk cost — modeled for
in-memory engines, *measured* for store-backed ones.

:class:`QueryServer` accepts a request stream, coalesces sources into
fixed-size batches (padding short batches by repeating the last
request, as the JAX package pads to its compiled batch shape), answers
repeats from an LRU cache of recent source rows, and accounts each
batch's index scan through the block-I/O model (DESIGN.md §9) — one
scan of F_f + core + F_b *per batch*, which is the amortization HoD's
sweep structure buys (every source in the batch shares the scan).

Mixed traffic (DESIGN.md §12): one server can admit several query modes
at once (``modes=("ssd", "p2p")``) and schedule them under per-class
latency targets.  ``scheduler="fifo"`` is the single-queue baseline —
every class shares one arrival-ordered queue, one size trigger and one
``max_wait_ms`` timer.  ``scheduler="slo"`` gives each class its own
admission queue and flushes a batch when the oldest pending request's
class deadline would otherwise be missed (deadline minus an EWMA of the
class's recent batch time), not only on size or a global timer.
Per-class p50/p99 and deadline misses land in the ``obs`` registry
(``latency_ms.<mode>[.cached|.cold]``, ``slo.miss.<mode>``) and in
:meth:`QueryServer.slo_report`.

Index residency (DESIGN.md §6, §13):

* ``QueryServer(engine)`` — an in-memory engine; each batch charges one
  *synthetic* sequential scan to the block-I/O model;
* ``QueryServer(store_path=..., cache_bytes=...)`` — store-backed: a
  ``StreamingQueryEngine`` streams the plans from the block store
  through a page cache of ``cache_bytes`` (``cache_policy``,
  ``pin_frac``) and a read pipeline (``queue_depth``,
  ``decode_workers``); the device meters the actual block reads (cache
  misses), and ``ServerStats``/``BatchIO`` report them beside the
  modeled scan;
* ``QueryServer(store_path=..., shards=N)`` — the same store served by
  an N-shard :class:`~repro_torch.fleet.ServingFleet`: per-shard page
  caches split the ``cache_bytes`` budget, per-shard worker pools read
  and decode, and the engine is the unsharded one, so the answers are
  too.

This is the counterpart of the JAX package's ``QueryServer``: on the
same request stream, the same answers, batches, padding, cache hits,
I/O bytes and per-class request counts, in the closed-loop
:meth:`~QueryServer.serve_stream` and the async
:meth:`~QueryServer.submit` path under both schedulers.  The engine's
device decides where the sweeps run (the card unless ``--device cpu``).
``serve.use_pallas`` is
accepted, since the checked-in configs carry it, and has no effect: the
card always runs the hand-written kernels and the CPU their plain
versions.

The CLI is an override layer over the config spine
(:mod:`repro_torch.config`): ``--config configs/serve_mixed.yaml``
loads a file with its ``_include`` chain and every explicitly typed
flag wins over it (built-in defaults < include chain < file < CLI).

    PYTHONPATH=src python -m repro_torch.launch.serve --side 200 --batch 32 \\
        --closure-limit 16384
    PYTHONPATH=src python -m repro_torch.launch.serve --mode p2p --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --store \\
        --cache-frac 0.05 --codec delta --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --config configs/serve_mixed.yaml --side 12 --trace-out t.json
    PYTHONPATH=src python -m repro_torch.launch.serve --mode topk --k 10 \\
        --device cpu --side 12
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --config configs/serve_fleet.yaml --side 12
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --data-parallel --device cpu --side 12

``--data-parallel`` splits every batch's sources over the ranks of a
``("data",)`` mesh under the rules ``{"batch": "data"}`` (the engines'
batch split, ``core/query.py``).  The world comes from ``torchrun``'s
environment, else it is this one process; a rank runs on
``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo with ``--device
cpu``.  Rank 0 runs the whole front end (coalescer, scheduler, row
cache, tracer, open loop) and announces each engine call it makes to the
other ranks (:func:`_lead`), which make the same call on their own
engines (:func:`_follow`) until rank 0's stop: the SLO scheduler's
batches depend on wall time, so ranks forming their own batches would
issue mismatched collectives.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import dataclasses
import io
import json
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from .. import shardlib as sl
from ..config import (SERVE_DEFAULTS, Config, ConfigError,
                      overrides_from_args, validate_serve)
from ..core.build import BuildConfig
from ..core.build_fast import build_hod_fast
from ..core.closeness import topk_closeness
from ..core.graph import grid_road_graph, power_law_digraph
from ..core.index import core_scan_bytes, pack_index
from ..core.io_sim import BlockDevice, IOStats
from ..core.query import QueryEngine
from ..fleet import ServingFleet
from ..obs.metrics import Histogram, MetricsRegistry
from ..obs.trace import Tracer, span_if
from ..storage import (IndexStore, PageCache, StreamingQueryEngine,
                       segment_bytes, segment_logical_bytes)
from .mesh import distributed

__all__ = ["QueryResult", "ServerStats", "BatchIO", "ClassSLO",
           "QueryServer", "server_from_config", "mixed_request_stream",
           "main"]

@dataclasses.dataclass
class QueryResult:
    """One answered request."""

    source: int
    dist: np.ndarray                    # [n] distances, original node order
    #                                     (p2p: a scalar; knn: [k] distances)
    pred: Optional[np.ndarray] = None   # [n] predecessors (SSSP mode only)
    nodes: Optional[np.ndarray] = None  # knn mode: [k] nearest node ids
    target: Optional[int] = None        # p2p mode: the other endpoint
    mode: str = ""                      # query mode that answered this
    latency_s: float = 0.0              # submit -> answer (includes waiting)
    batched_with: int = 1               # real requests sharing the batch
    cached: bool = False                # answered from the LRU cache
    io_bytes: float = 0.0               # this request's share of the scan


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    cache_hits: int = 0                 # result-row LRU hits
    padded_slots: int = 0               # filler rows executed
    busy_seconds: float = 0.0           # time inside the engine
    deadline_misses: int = 0            # SLO-classed answers past deadline
    page_hits: int = 0                  # store page-cache block hits
    page_misses: int = 0                # store page-cache block misses
    store_bytes_read: int = 0           # actual bytes read from segments
    #: decompressed bytes the cache was filled with; exceeds
    #: ``store_bytes_read`` on codec stores (decompress-on-fill)
    store_bytes_filled: int = 0
    # Read-pipeline overlap metrics (store-backed with prefetch):
    stall_seconds: float = 0.0          # modeled consumer wait on the device
    stall_wall_seconds: float = 0.0     # measured wait for in-flight fills
    ttfl_seconds: float = 0.0           # time-to-first-level, first sweep

    def throughput(self) -> float:
        return self.requests / self.busy_seconds if self.busy_seconds else 0.0

    def page_hit_rate(self) -> float:
        total = self.page_hits + self.page_misses
        return self.page_hits / total if total else 0.0

    def report(self, label: str = "", batch_size: Optional[int] = None,
               latency: Optional[Histogram] = None,
               slo_rows: Optional[List[dict]] = None,
               fleet_stats=None) -> str:
        """Human-readable serving summary (the CLI footer).  ``latency``
        is the served mode's ``latency_ms.*`` histogram; ``slo_rows``
        (:meth:`QueryServer.slo_report`) adds one line per traffic class
        with its deadline accounting; ``fleet_stats``
        (:meth:`QueryServer.fleet_report`) one line per serving shard."""
        extras = []
        if batch_size is not None:
            extras.append(f"batch={batch_size}")
        extras += [f"{self.cache_hits} cache hits",
                   f"{self.padded_slots} padded slots"]
        what = f"{label} requests" if label else "requests"
        lines = [f"served {self.requests} {what} in "
                 f"{self.batches} batches ({', '.join(extras)})"]
        if latency is not None and latency.count:
            s = latency.summary()
            lines.append(f"latency: mean {s['mean']:.2f} ms  "
                         f"p50 {s['p50']:.2f}  p95 {s['p95']:.2f}  "
                         f"p99 {s['p99']:.2f} ms")
        for row in slo_rows or ():
            dl = (f"deadline {row['deadline_ms']:g} ms, "
                  f"{row['deadline_misses']}/{row['requests']} missed"
                  if row.get("deadline_ms") else "no deadline")
            lines.append(
                f"class {row['cls']:<12} p50 {row['p50_ms']:.2f}  "
                f"p99 {row['p99_ms']:.2f} ms  "
                f"({row['requests']} answered, {dl})")
        if fleet_stats is not None:
            lines.append(f"fleet: {len(fleet_stats.rows)} shards, "
                         f"aggregate hit rate "
                         f"{fleet_stats.cache.hit_rate():.3f}, "
                         f"{fleet_stats.cache.bytes_read / 1e6:.1f} MB "
                         "read")
            lines.extend(fleet_stats.report_lines())
        lines.append(f"throughput: {self.throughput():.0f} queries/s "
                     "(engine-busy basis)")
        return "\n".join(lines)


@dataclasses.dataclass
class BatchIO:
    """Real-vs-modeled I/O of one executed batch (store-backed servers).
    ``page_hits / (page_hits + page_misses)`` is the batch's hit rate."""

    batch: int                          # stats.batches ordinal
    real_bytes: int                     # actual segment bytes read (misses;
    #                                     compressed bytes on codec stores)
    modeled_bytes: int                  # compact-payload scan model
    page_hits: int = 0
    page_misses: int = 0
    filled_bytes: int = 0               # decompressed bytes cached
    stall_s: float = 0.0                # modeled pipeline stall this batch


@dataclasses.dataclass(frozen=True)
class ClassSLO:
    """Latency target of one traffic class (DESIGN.md §12).

    ``deadline_ms`` is the submit→answer budget; the scheduler flushes
    the class's queue early enough that the oldest rider can still be
    executed inside it (deadline minus the class's recent batch-time
    EWMA).  ``batch`` caps how many requests one flush admits (the batch
    shape stays the server's ``batch_size`` — a smaller class batch is
    an admission cap, padded up like any partial batch)."""

    deadline_ms: float
    batch: Optional[int] = None

    def __post_init__(self):
        if not self.deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, "
                             f"got {self.deadline_ms!r}")
        if self.batch is not None and self.batch < 1:
            raise ValueError(f"class batch must be >= 1, "
                             f"got {self.batch!r}")


#: One queued request: (request key, future, submit time, mode).
_Pending = Tuple[object, "asyncio.Future", float, str]

#: Shared single-arrival queue key under ``scheduler="fifo"``.
_FIFO = "_fifo"


class QueryServer:
    """Coalesces HoD query requests into fixed-size batched sweeps.

    Every batch runs at exactly ``batch_size`` requests — short batches
    are padded by repeating the last request.  ``max_wait_ms`` bounds how
    long a lone request waits for co-riders before a partial batch is
    flushed anyway.

    ``mode`` picks the query type (DESIGN.md §7): ``"ssd"`` (full
    single-source distances; ``sssp=False``), ``"sssp"`` (distances +
    predecessors; ``sssp=True``), ``"p2p"`` (requests are ``(source,
    target)`` pairs, answers scalar distances), ``"within"`` (distances
    clamped to ``within_d``) or ``"knn"`` (the ``knn_k`` nearest nodes of
    each source).

    ``modes=("ssd", "p2p", ...)`` admits several query types into one
    server (mixed traffic); ``mode`` then names the *primary* class
    (what :meth:`serve_stream` and a mode-less :meth:`submit` use).
    ``scheduler`` picks the admission policy — ``"fifo"`` (one shared
    arrival queue) or ``"slo"`` (per-class queues with deadline-aware
    flushing, configured by ``slo={mode: ClassSLO(...)}``; classes
    without an SLO fall back to ``max_wait_ms``).

    ``device`` is the block-I/O model each batch's scan is charged to
    (a fresh :class:`~repro_torch.core.io_sim.BlockDevice` by default),
    as in the JAX package; the torch device is the engine's.
    ``warm_start`` runs :meth:`warmup` at construction.  ``tracer`` (a
    :class:`~repro_torch.obs.trace.Tracer`) threads down through the
    engine into the pipeline, cache and device hooks, and in memory
    into the engine's phase spans and the front end's ``server.rows``
    and ``server.resolve`` (``obs/trace.py``); ``metrics`` is the
    registry the per-mode latency histograms and server counters go to
    (a fresh one by default).

    Pass ``store_path`` instead of ``engine`` to serve from a block
    store: the page cache holds ``cache_bytes`` of decompressed blocks
    under ``cache_policy`` (``pin_frac`` of it reservable by pins), the
    read pipeline keeps ``queue_depth`` levels in flight with
    ``decode_workers`` decoders (``None`` keeps the engine's defaults),
    and ``engine_opts`` go to the ``StreamingQueryEngine`` (its
    ``device``, ``core_mode``, ``prefetch``).  ``device`` then meters
    the store's reads.  ``shards=N`` serves the store as an N-shard
    :class:`~repro_torch.fleet.ServingFleet` instead (``cache_bytes``
    is the fleet-wide budget; the fleet meters its own per-shard
    devices, so ``device`` must be ``None``).  :meth:`close` releases
    the segment files and the pipeline's (and shards') threads.
    """

    MODES = ("ssd", "sssp", "p2p", "within", "knn")
    SCHEDULERS = ("fifo", "slo")
    #: EWMA factor for per-class batch-execution estimates.
    EXEC_EWMA_ALPHA = 0.3
    #: Deadline headroom: flush at ``deadline - HEADROOM * exec_est``.
    #: The factor above 1 absorbs EWMA estimation error and event-loop
    #: contention (another class's batch may hold the loop when this
    #: queue comes due).
    SLO_HEADROOM = 2.0

    def __init__(self, engine: Optional[QueryEngine] = None,
                 batch_size: int = 32,
                 max_wait_ms: float = 2.0, cache_entries: int = 1024,
                 sssp: bool = False, mode: Optional[str] = None,
                 modes: Optional[Tuple[str, ...]] = None,
                 scheduler: str = "fifo",
                 slo: Optional[Dict[str, object]] = None,
                 within_d: float = float("inf"), knn_k: int = 10,
                 device: Optional[BlockDevice] = None,
                 warm_start: bool = False,
                 store_path: Optional[str] = None,
                 cache_bytes: Optional[int] = None,
                 cache_policy: str = "2q",
                 pin_frac: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 decode_workers: Optional[int] = None,
                 shards: Optional[int] = None,
                 engine_opts: Optional[dict] = None,
                 tracer=None,
                 metrics: Optional[MetricsRegistry] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not max_wait_ms >= 0:
            raise ValueError(f"max_wait_ms must be >= 0, "
                             f"got {max_wait_ms!r}")
        if cache_entries < 0:
            raise ValueError(f"cache_entries must be >= 0, "
                             f"got {cache_entries!r}")
        if not within_d > 0:
            raise ValueError(f"within_d must be > 0, got {within_d!r}")
        if knn_k < 1:
            raise ValueError(f"knn_k must be >= 1, got {knn_k!r}")
        if queue_depth is not None and queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, "
                             f"got {queue_depth!r}")
        if decode_workers is not None and decode_workers < 1:
            raise ValueError(f"decode_workers must be >= 1, "
                             f"got {decode_workers!r}")
        if pin_frac is not None and not 0.0 <= pin_frac <= 1.0:
            raise ValueError(f"pin_frac must be in [0, 1], "
                             f"got {pin_frac!r}")
        if shards is not None:
            if shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards!r}")
            if engine is not None:
                raise ValueError("shards applies to store-backed "
                                 "serving (pass store_path, not engine)")
            if device is not None:
                raise ValueError("pass device or shards, not both — "
                                 "a sharded fleet meters its own "
                                 "per-shard devices")
        if scheduler not in self.SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r} "
                             f"(one of {self.SCHEDULERS})")
        if mode is None:
            mode = ("sssp" if sssp
                    else (modes[0] if modes else "ssd"))
        elif sssp and mode != "sssp":
            raise ValueError(f"sssp=True contradicts mode={mode!r}")
        if modes is None:
            modes = (mode,)
        elif mode not in modes:
            raise ValueError(f"primary mode {mode!r} missing from "
                             f"modes={modes!r}")
        for m in modes:
            if m not in self.MODES:
                raise ValueError(f"unknown mode {m!r} "
                                 f"(one of {self.MODES})")
        if len(set(modes)) != len(modes):
            raise ValueError(f"duplicate modes in {modes!r}")
        self._slo: Dict[str, ClassSLO] = {}
        for cls_name, spec in (slo or {}).items():
            if cls_name not in modes:
                raise ValueError(f"SLO class {cls_name!r} is not an "
                                 f"admitted mode {modes!r}")
            if isinstance(spec, ClassSLO):
                self._slo[cls_name] = spec
            elif isinstance(spec, dict):
                self._slo[cls_name] = ClassSLO(
                    deadline_ms=float(spec["deadline_ms"]),
                    batch=spec.get("batch"))
            else:
                raise ValueError(f"slo[{cls_name!r}] must be a ClassSLO "
                                 f"or mapping, got {spec!r}")
        if engine is None:
            if store_path is None:
                raise ValueError("pass an engine or a store_path")
            engine = self._store_engine(
                store_path, device, cache_bytes, cache_policy, pin_frac,
                queue_depth, decode_workers, shards, engine_opts)
            device = engine.store.device
        elif store_path is not None:
            raise ValueError("pass either an engine or a store_path, "
                             "not both")
        self.engine = engine
        self.store = getattr(engine, "store", None)   # None = in-memory
        self.fleet = getattr(engine, "fleet", None)   # None = unsharded
        # Observability (DESIGN.md §11): the tracer threads down through
        # the engine into the pipeline/cache/device hooks; the registry
        # holds the per-mode latency histograms and server counters.
        self.tracer = tracer
        # The front end's own spans (server.rows, server.resolve) are the
        # port's, and in-memory only: a store server's query thread
        # traces the JAX package's sequence.
        self._front_tracer = tracer if self.store is None else None
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if tracer is not None:
            if hasattr(engine, "set_tracer"):
                engine.set_tracer(tracer)
            else:
                engine.tracer = tracer
        pipe = getattr(engine, "_pipe", None)
        if pipe is not None:
            self.metrics.gauge("pipeline.queue_depth").set(
                pipe.queue_depth)
        self.batch_size = int(batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.cache_entries = int(cache_entries)
        self.mode = mode
        self.modes = tuple(modes)
        self.scheduler = scheduler
        self.sssp = mode == "sssp"
        self.within_d = float(within_d)
        self.knn_k = int(knn_k)
        self.device = device or BlockDevice()
        self.stats = ServerStats()
        self.batch_io: List[BatchIO] = []
        # Cache / pending keys are ints (one source) or (source, target)
        # tuples (p2p), namespaced by mode and the mode's parameters
        # (_cache_key).
        self._cache: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        # Admission queues (DESIGN.md §12): one shared arrival queue
        # under "fifo", one queue per class under "slo".
        self._queues: Dict[str, List[_Pending]] = {}
        self._timer: Optional[asyncio.Task] = None
        #: Absolute flush-by time the armed timer targets (perf_counter
        #: seconds), read by the fake-clock tests.
        self._timer_deadline: Optional[float] = None
        #: Per-class EWMA of batch execution seconds (deadline headroom).
        self._exec_ewma: Dict[str, float] = {}
        self._last_batch_bytes = 0.0    # real (store) or modeled (in-mem)

        # One batch's disk cost = one sequential scan of the index
        # "files" (paper §5: traversal order == file order): the plans
        # the executor scans (assoc slots only when SSSP reconstruction
        # runs) plus whichever core structure core_mode reads.  A
        # store-backed server keeps it as the model its real reads are
        # compared with; only in-memory engines charge it to the device.
        self._mode_sweep_bytes: Dict[str, int] = {}
        for m in self.modes:
            m_sssp = m == "sssp"
            if self.store is not None:
                self._mode_sweep_bytes[m] = self.store.scan_bytes(
                    sssp=m_sssp, core_mode=engine.core_mode)
            else:
                ix = engine.index
                self._mode_sweep_bytes[m] = (
                    ix.plan_f.scan_bytes(include_assoc=m_sssp)
                    + ix.plan_b.scan_bytes(include_assoc=m_sssp)
                    + (ix.plan_core.scan_bytes(True) if m_sssp else 0)
                    + core_scan_bytes(ix, engine.core_mode))
        self._sweep_bytes = self._mode_sweep_bytes[self.mode]
        if warm_start:
            self.warmup()

    @staticmethod
    def _store_engine(store_path, device, cache_bytes, cache_policy,
                      pin_frac, queue_depth, decode_workers, shards,
                      engine_opts):
        """A ``StreamingQueryEngine`` over the store at ``store_path``
        behind a fresh page cache (DESIGN.md §6), or behind the routing
        façades of an N-shard fleet (DESIGN.md §13) when ``shards`` is
        set: the engine is the unsharded one either way."""
        if shards is not None:
            store = ServingFleet(
                store_path, shards, cache_bytes=cache_bytes,
                cache_policy=cache_policy, pin_frac=pin_frac,
                decode_workers=(decode_workers
                                if decode_workers is not None else 2)
            ).store
        else:
            store = IndexStore(store_path, device=device,
                               cache=PageCache(cache_bytes,
                                               policy=cache_policy,
                                               pin_frac=pin_frac))
        opts = dict(engine_opts or {})
        if queue_depth is not None:
            opts.setdefault("queue_depth", queue_depth)
        if decode_workers is not None:
            opts.setdefault("decode_workers", decode_workers)
        try:
            return StreamingQueryEngine(store, **opts)
        except Exception:
            store.close()   # don't leak the opened segments
            raise

    # ------------------------------------------------------------- internals
    def _now(self) -> float:
        """Monotonic clock — a seam the fake-clock tests patch."""
        return time.perf_counter()

    def _keys(self, requests: np.ndarray) -> List:
        """Hashable request identities: ints, or (source, target) pairs."""
        if requests.ndim == 2:
            return [(int(s), int(t)) for s, t in requests]
        return [int(s) for s in requests]

    def _cache_key(self, req, mode: Optional[str] = None) -> tuple:
        """LRU namespace: the mode *plus the parameter that shapes its
        answer* (``within`` rows depend on the threshold, ``knn`` rows on
        k), so a server with several modes never answers one mode's
        request with another's row, and a reconfigured live server never
        replays a row computed under the old parameter."""
        mode = mode or self.mode
        if mode == "within":
            return (mode, self.within_d, req)
        if mode == "knn":
            return (mode, self.knn_k, req)
        return (mode, None, req)

    def _cache_get(self, req, mode: Optional[str] = None):
        key = self._cache_key(req, mode)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, req, row: tuple,
                   mode: Optional[str] = None) -> None:
        if self.cache_entries <= 0:
            return
        key = self._cache_key(req, mode)
        self._cache[key] = row
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_entries:
            self._cache.popitem(last=False)

    def _execute(self, requests: np.ndarray,
                 mode: Optional[str] = None) -> List[tuple]:
        """Run one padded batch; returns one (dist, pred) row per request
        (``requests`` is ``[B]`` sources, or ``[B, 2]`` pairs in p2p).

        The ``jit.dispatch`` span keeps the reference's name so that
        traces of both packages line up; here it covers the kernel
        launches *and* the answer's copy back to the host.  The engines
        return host numpy (``QueryEngine._to_host`` synchronizes), so
        the busy time that feeds ``busy_seconds`` and the class's EWMA —
        and through it the SLO flush-by times — is the batch's true
        time, not only its launch time."""
        mode = mode or self.mode
        fill = requests.shape[0]
        batch = requests
        if fill < self.batch_size:     # pad to the fixed batch shape
            pad = ((0, self.batch_size - fill),) + ((0, 0),) * (
                requests.ndim - 1)
            batch = np.pad(requests, pad, mode="edge")
        before = (self.store.cache.stats.snapshot()
                  if self.store is not None else None)
        pstats = (self.engine.pipeline_stats()
                  if hasattr(self.engine, "pipeline_stats") else None)
        pbefore = pstats.snapshot() if pstats is not None else None
        t0 = time.perf_counter()
        with span_if(self.tracer, f"query.{mode}",
                     batch=self.stats.batches + 1, fill=fill), \
             span_if(self.tracer, "jit.dispatch", mode=mode):
            if mode == "sssp":
                dist, pred = self.engine.sssp(batch)
            elif mode == "p2p":
                dist, pred = (self.engine.p2p(batch[:, 0], batch[:, 1]),
                              None)
            elif mode == "within":
                dist, pred = (self.engine.ssd_within(batch,
                                                     self.within_d), None)
            elif mode == "knn":
                # rows carry (distances, node ids); _row_fields unpacks
                pred, dist = self.engine.knn(batch, self.knn_k)
            else:
                dist, pred = self.engine.ssd(batch), None
        busy = time.perf_counter() - t0   # answers are on the host here
        self.stats.busy_seconds += busy
        # Per-class execution estimate (deadline headroom, DESIGN.md
        # §12): an EWMA, so one slow cold batch does not lock in.
        prev = self._exec_ewma.get(mode)
        a = self.EXEC_EWMA_ALPHA
        self._exec_ewma[mode] = (busy if prev is None
                                 else (1 - a) * prev + a * busy)
        pdelta = (pstats - pbefore) if pstats is not None else None
        if pdelta is not None:
            self.stats.stall_seconds += pdelta.stall_model_s
            self.stats.stall_wall_seconds += pdelta.stall_wall_s
            if self.stats.ttfl_seconds == 0.0:
                self.stats.ttfl_seconds = pdelta.ttfl_s
        self.stats.batches += 1
        self.stats.padded_slots += self.batch_size - fill
        m = self.metrics
        m.counter("server.batches").inc()
        m.counter(f"server.batches.{mode}").inc()
        m.counter("server.padded_slots").inc(self.batch_size - fill)
        m.counter("server.busy_seconds").inc(busy)
        if pdelta is not None:
            m.counter("pipeline.stall_seconds").inc(pdelta.stall_model_s)
        if self.store is None:
            # No real reads happen: charge the modeled sequential scan.
            self.device.sequential(self._mode_sweep_bytes[mode])
            self._last_batch_bytes = float(self._mode_sweep_bytes[mode])
        else:
            # The page cache already metered every actual block read
            # (miss) through the device: record the batch's delta.
            delta = self.store.cache.stats - before
            st = self.stats
            st.page_hits += delta.hits
            st.page_misses += delta.misses
            st.store_bytes_read += delta.bytes_read
            st.store_bytes_filled += delta.bytes_filled
            self.batch_io.append(BatchIO(
                batch=st.batches, real_bytes=delta.bytes_read,
                modeled_bytes=self._mode_sweep_bytes[mode],
                page_hits=delta.hits, page_misses=delta.misses,
                filled_bytes=delta.bytes_filled,
                stall_s=pdelta.stall_model_s if pdelta else 0.0))
            self._last_batch_bytes = float(delta.bytes_read)
            m.counter("page_cache.hits").inc(delta.hits)
            m.counter("page_cache.misses").inc(delta.misses)
            m.counter("store.bytes_read").inc(delta.bytes_read)
            m.counter("store.bytes_filled").inc(delta.bytes_filled)
            m.gauge("page_cache.hit_rate").set(st.page_hit_rate())
        rows = []
        with span_if(self._front_tracer, "server.rows"):
            for i, req in enumerate(self._keys(requests)):
                if mode == "p2p":          # scalar answer per pair
                    row = (np.float32(dist[i]), None)
                else:
                    row = (dist[i].copy(),
                           None if pred is None else pred[i].copy())
                self._cache_put(req, row, mode)
                rows.append(row)
        return rows

    def _observe(self, latency_s: float, cached: bool,
                 mode: Optional[str] = None) -> None:
        """Per-request metrics: the request counters, the per-mode and
        per-class (``.cached`` / ``.cold``) latency histograms, and —
        when the class has an SLO — deadline-miss accounting."""
        mode = mode or self.mode
        m = self.metrics
        m.counter("server.requests").inc()
        ms = latency_s * 1e3
        m.histogram(f"latency_ms.{mode}").observe(ms)
        if cached:
            m.counter("server.result_cache_hits").inc()
            m.histogram(f"latency_ms.{mode}.cached").observe(ms)
        else:
            m.histogram(f"latency_ms.{mode}.cold").observe(ms)
        cls = self._slo.get(mode)
        if cls is not None:
            m.counter(f"slo.requests.{mode}").inc()
            if ms > cls.deadline_ms:
                m.counter(f"slo.miss.{mode}").inc()
                self.stats.deadline_misses += 1

    def _row_fields(self, row: tuple, mode: Optional[str] = None) -> tuple:
        """Split a cached row into ``(dist, pred, nodes)`` — knn rows
        carry node ids in the second slot, SSSP rows predecessors."""
        if (mode or self.mode) == "knn":
            return row[0], None, row[1]
        return row[0], row[1], None

    # ------------------------------------------------------------- sync path
    def warmup(self) -> None:
        """Run one padded batch of every admitted mode outside the
        latency path (kernel builds, first launches, allocator growth),
        then a second pass whose times seed the per-class execution
        estimates — the first pass's are far above steady state and
        would make the deadline scheduler flush every early batch at
        once.  Then zero every counter, the row cache, the I/O model and
        the tracer.  A store-backed server keeps the warmed blocks
        resident (what a warm start buys) and zeroes the page cache's,
        the device's and the pipeline's counters under the cache's lock,
        in one reset."""
        for m in self.modes:
            shape = (1, 2) if m == "p2p" else (1,)
            self._execute(np.zeros(shape, dtype=np.int32), mode=m)
        self._exec_ewma.clear()
        for m in self.modes:
            shape = (1, 2) if m == "p2p" else (1,)
            self._execute(np.zeros(shape, dtype=np.int32), mode=m)
        self.stats = ServerStats()
        self.batch_io.clear()
        self._cache.clear()   # the warmup row must not count as a hit
        ps = (self.engine.pipeline_stats()
              if hasattr(self.engine, "pipeline_stats") else None)
        if self.store is not None:
            also = [self.device.reset]
            if ps is not None:
                also.append(ps.reset)  # no stall/ttfl from warmup sweeps
            self.store.cache.reset_stats(also=also)
        else:
            self.device.reset()
        self.metrics.reset()
        if self.tracer is not None:
            self.tracer.clear()   # warm-up spans stay out of the trace

    def serve_stream(self, requests: np.ndarray,
                     mode: Optional[str] = None) -> List[QueryResult]:
        """Closed-loop serving: answer a request list in arrival order.

        ``requests`` is ``[N]`` sources — or ``[N, 2]`` (source, target)
        rows in p2p mode.  All requests of a chunk arrive together, so
        each one's ``latency_s`` is the full chunk wall time — divide by
        ``batched_with`` for the amortized per-query cost.
        """
        mode = mode or self.mode
        if mode not in self.modes:
            raise ValueError(f"mode {mode!r} not admitted "
                             f"(modes={self.modes!r})")
        requests = np.asarray(requests, dtype=np.int32)
        if (requests.ndim == 2) != (mode == "p2p"):
            raise ValueError("p2p mode takes [N, 2] (source, target) "
                             "rows; other modes take [N] sources")
        out: List[QueryResult] = []
        for lo in range(0, requests.shape[0], self.batch_size):
            chunk = requests[lo: lo + self.batch_size]
            t0 = time.perf_counter()
            hit_rows = {k: self._cache_get(k, mode)
                        for k in self._keys(chunk)}
            misses = sorted(k for k, row in hit_rows.items() if row is None)
            miss_rows: Dict[object, tuple] = {}
            if misses:
                uniq = np.asarray(misses, dtype=np.int32)
                for k, row in zip(misses, self._execute(uniq, mode)):
                    miss_rows[k] = row
            lat = time.perf_counter() - t0
            share = self._last_batch_bytes / len(misses) if misses else 0.0
            charged = set()   # charge each missed request's share once
            for k in self._keys(chunk):
                cached = k not in miss_rows
                # A hit evicted by this chunk's own misses (a cache
                # smaller than the chunk) is answered from its snapshot.
                row = (miss_rows.get(k) or self._cache_get(k, mode)
                       or hit_rows[k])
                self.stats.requests += 1
                self.stats.cache_hits += cached
                self._observe(lat, cached, mode)
                src, tgt = k if isinstance(k, tuple) else (k, None)
                d, p, nd = self._row_fields(row, mode)
                out.append(QueryResult(
                    source=src, target=tgt, dist=d, pred=p, nodes=nd,
                    mode=mode, latency_s=lat, batched_with=chunk.shape[0],
                    cached=cached,
                    io_bytes=0.0 if (cached or k in charged) else share))
                charged.add(k)
        return out

    # ------------------------------------------------------------ async path
    async def submit(self, source: int,
                     target: Optional[int] = None,
                     mode: Optional[str] = None) -> QueryResult:
        """Enqueue one request; resolves when its batch executes (or on a
        cache hit, at once).  p2p mode requires ``target``; ``mode``
        (default: the server's primary) must be admitted.  The batch
        runs on the event loop's thread, as in the reference: which
        requests share a batch depends on it."""
        mode = mode or self.mode
        if mode not in self.modes:
            raise ValueError(f"mode {mode!r} not admitted "
                             f"(modes={self.modes!r})")
        if (target is not None) != (mode == "p2p"):
            raise ValueError("target is required in p2p mode and "
                             "meaningless otherwise")
        req = ((int(source), int(target)) if target is not None
               else int(source))
        t0 = self._now()
        hit = self._cache_get(req, mode)
        if hit is not None:
            self.stats.requests += 1
            self.stats.cache_hits += 1
            lat = self._now() - t0
            self._observe(lat, cached=True, mode=mode)
            d, p, nd = self._row_fields(hit, mode)
            return QueryResult(source=int(source), target=target,
                               dist=d, pred=p, nodes=nd, mode=mode,
                               latency_s=lat, cached=True)
        fut = asyncio.get_running_loop().create_future()
        qkey = _FIFO if self.scheduler == "fifo" else mode
        self._queues.setdefault(qkey, []).append((req, fut, t0, mode))
        if len(self._queues[qkey]) >= self._take_size(qkey):
            self._flush_queue(qkey, partial=False)
        # The timer is always re-derived from the oldest pending
        # deadlines after a queue changes: a straggler left by a
        # full-size flush keeps its own submit-time budget.
        self._arm_timer()
        return await fut

    # --------------------------------------------------- scheduler internals
    def _take_size(self, qkey: str) -> int:
        """Size trigger / flush width of one queue (per-class caps)."""
        cls = self._slo.get(qkey)
        if cls is not None and cls.batch is not None:
            return min(cls.batch, self.batch_size)
        return self.batch_size

    def _flush_by(self, entry: _Pending) -> float:
        """Absolute time this entry's queue must flush by (DESIGN.md
        §12): its class deadline minus ``SLO_HEADROOM`` times the class's
        batch-time EWMA (clamped at the submit time, so an already
        hopeless deadline still flushes at once rather than never).
        Classes without an SLO use ``max_wait_ms``."""
        _, _, t0, mode = entry
        cls = self._slo.get(mode) if self.scheduler == "slo" else None
        if cls is None:
            return t0 + self.max_wait_ms / 1e3
        est = self._exec_ewma.get(mode, 0.0)
        return max(t0, t0 + cls.deadline_ms / 1e3
                   - self.SLO_HEADROOM * est)

    def _earliest_flush_by(self) -> Optional[float]:
        cands = [self._flush_by(q[0])
                 for q in self._queues.values() if q]
        return min(cands) if cands else None

    def _arm_timer(self) -> None:
        """(Re)arm the single flush timer at the earliest flush-by time
        over every queue; disarm when nothing is pending.  Called after
        every queue change, so the timer's deadline is a pure function
        of the pending set."""
        earliest = self._earliest_flush_by()
        if earliest is None:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._timer_deadline = None
            return
        if (self._timer is not None
                and self._timer_deadline is not None
                and abs(self._timer_deadline - earliest) < 1e-9):
            return   # already armed for exactly this deadline
        if self._timer is not None:
            self._timer.cancel()
        self._timer_deadline = earliest
        delay = max(0.0, earliest - self._now())
        self._timer = asyncio.create_task(self._flush_later(delay))

    async def _flush_later(self, delay: float) -> None:
        await asyncio.sleep(delay)
        self._timer = None
        self._timer_deadline = None
        self._flush_due()

    def _flush_due(self) -> None:
        """Timer body: flush every queue whose oldest rider is due (or
        that reached its size trigger), most urgent class first, then
        re-arm for whatever is left."""
        while True:
            now = self._now()
            due = [(self._flush_by(q[0]), qkey)
                   for qkey, q in self._queues.items()
                   if q and (len(q) >= self._take_size(qkey)
                             or self._flush_by(q[0]) <= now)]
            if not due:
                break
            due.sort()
            for _, qkey in due:
                self._flush_queue(qkey, partial=True, only_due=True)
        self._arm_timer()

    def _flush_queue(self, qkey: str, partial: bool = True,
                     only_due: bool = False) -> None:
        """Flush one admission queue: full takes always, a trailing
        partial take when ``partial`` (and, under ``only_due``, only
        while its oldest rider is due)."""
        q = self._queues.get(qkey)
        while q:
            width = self._take_size(qkey)
            if len(q) < width:
                if not partial:
                    break
                if only_due and self._flush_by(q[0]) > self._now():
                    break
            take, self._queues[qkey] = q[:width], q[width:]
            q = self._queues[qkey]
            self._run_batch(take)

    def _run_batch(self, take: List[_Pending]) -> None:
        """Execute one flushed take: split it into per-mode sub-batches
        in arrival order (a fifo take can mix classes), resolve the
        futures, and do the latency/deadline accounting."""
        # Coalesce wait: the oldest rider's queue time, as a
        # retroactive X span (its duration is only known now).
        wait_s = self._now() - min(t0 for _, _, t0, _ in take)
        self.metrics.histogram("coalesce_wait_ms").observe(wait_s * 1e3)
        if self.tracer is not None:
            self.tracer.complete(
                "coalesce.wait",
                self.tracer.now() - int(wait_s * 1e9),
                waiters=len(take))
        groups: "collections.OrderedDict[str, List[_Pending]]" = \
            collections.OrderedDict()
        for entry in take:
            groups.setdefault(entry[3], []).append(entry)
        for mode, entries in groups.items():
            reqs = np.asarray([r for r, _, _, _ in entries],
                              dtype=np.int32)
            try:
                rows = self._execute(reqs, mode)
            except Exception as exc:
                # Never strand co-riders: a poisoned batch (e.g. an
                # out-of-range source) fails every request in it.
                for _, fut, _, _ in entries:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            share = self._last_batch_bytes / len(entries)
            now = self._now()
            with span_if(self._front_tracer, "server.resolve"):
                for (req, fut, t0, _), row in zip(entries, rows):
                    self.stats.requests += 1
                    self._observe(now - t0, cached=False, mode=mode)
                    src, tgt = req if isinstance(req, tuple) \
                        else (req, None)
                    if not fut.done():
                        d, p, nd = self._row_fields(row, mode)
                        fut.set_result(QueryResult(
                            source=src, target=tgt, dist=d, pred=p,
                            nodes=nd, mode=mode, latency_s=now - t0,
                            batched_with=len(entries), io_bytes=share))

    def _flush(self, include_partial: bool = True) -> None:
        """Flush every queue unconditionally (drain), then re-derive the
        timer from whatever remains."""
        for qkey in list(self._queues):
            self._flush_queue(qkey, partial=include_partial)
        self._arm_timer()

    async def drain(self) -> None:
        """Flush every queued request (shutdown / end of trace)."""
        self._flush()

    def pending_count(self) -> int:
        """Queued-but-unflushed requests (scheduler introspection)."""
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------- reporting
    def slo_report(self) -> List[dict]:
        """Per-class latency/deadline rows: one row per admitted mode
        plus its ``.cached`` / ``.cold`` sub-classes that saw traffic."""
        rows: List[dict] = []
        for mode in self.modes:
            cls = self._slo.get(mode)
            for sub in ("", ".cached", ".cold"):
                hist = self.metrics.histograms(
                    f"latency_ms.{mode}{sub}").get(
                        f"latency_ms.{mode}{sub}")
                if hist is None or not hist.count:
                    continue
                s = hist.summary()
                row = {"cls": f"{mode}{sub}", "mode": mode,
                       "requests": s["count"], "mean_ms": s["mean"],
                       "p50_ms": s["p50"], "p99_ms": s["p99"],
                       "deadline_ms": (cls.deadline_ms if cls else None),
                       "deadline_misses": 0}
                if cls is not None and sub == "":
                    row["deadline_misses"] = int(self.metrics.counter(
                        f"slo.miss.{mode}").value)
                rows.append(row)
        return rows

    def fleet_report(self):
        """Point-in-time :class:`repro_torch.fleet.FleetStats` snapshot
        (per-shard hit rates, bytes, budgets) of a sharded server;
        ``None`` when unsharded."""
        return self.fleet.stats() if self.fleet is not None else None

    @property
    def modeled_scan_bytes(self) -> int:
        """Compact-payload cost of one full index scan (the primary
        mode's; per-mode figures sit in ``_mode_sweep_bytes``)."""
        return self._sweep_bytes

    def modeled_io(self) -> IOStats:
        """The I/O model's counters: the synthetic per-batch scan charge
        (in-memory), or the store's actual block reads."""
        return self.device.stats

    def close(self) -> None:
        """Cancel the flush timer, fail every still-pending future (no
        submitter hangs on a closed server), and release the store's
        segment files and the pipeline's threads (store-backed)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
            self._timer_deadline = None
        for q in self._queues.values():
            for _, fut, _, _ in q:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError("QueryServer closed with the "
                                     "request still pending"))
            q.clear()
        if self.store is not None:
            self.engine.close()


# ----------------------------------------------------------- config plumbing
def server_from_config(cfg: Config, *, engine=None,
                       store_path: Optional[str] = None,
                       cache_bytes: Optional[int] = None,
                       device=None, tracer=None, metrics=None,
                       engine_opts: Optional[dict] = None) -> QueryServer:
    """Build a :class:`QueryServer` from a validated serve config
    (DESIGN.md §12).  The caller supplies the engine *or* the store path
    (graph, index and store construction stay outside the config
    spine); everything else — batch, scheduler, SLO classes, cache
    sizing, pipeline depth — comes from ``cfg``.  ``engine_opts`` go to
    a store-backed server's ``StreamingQueryEngine`` (its torch
    ``device``, ``core_mode``) under the config's ``store.prefetch``;
    ``serve.shards`` serves the store as a fleet.  ``serve.use_pallas``
    has no effect."""
    validate_serve(cfg)
    mode = cfg.get("serve.mode", "ssd")
    # CLI aliases -> server modes: "threshold" is served as "within";
    # "topk" is a batch job (topk_closeness driven by the caller after
    # construction), so its server runs plain ssd sweeps.
    mode = {"threshold": "within", "topk": "ssd"}.get(mode, mode)
    mix = cfg.get("serve.mix") or {}
    modes = tuple(mix) if mix else (mode,)
    if mode not in modes:
        mode = modes[0]
    for m in modes:
        if m not in QueryServer.MODES:
            raise ConfigError(f"config key 'serve.mix' names unknown "
                              f"mode {m!r} (one of {QueryServer.MODES})")
    slo = {}
    for m, spec in (cfg.get("serve.slo") or {}).items():
        # Mirror QueryServer's constructor check: a typo'd class name
        # must not silently serve with no deadline.
        if m not in modes:
            raise ConfigError(
                f"config key 'serve.slo.{m}' names a class outside the "
                f"admitted modes {modes} (fix the name or add it to "
                f"'serve.mix')")
        slo[m] = ClassSLO(deadline_ms=float(spec["deadline_ms"]),
                          batch=spec.get("batch"))
    kw = dict(batch_size=cfg.get("serve.batch", 32),
              max_wait_ms=cfg.get("serve.max_wait_ms", 2.0),
              cache_entries=cfg.get("serve.cache_entries", 1024),
              mode=mode, modes=modes,
              scheduler=cfg.get("serve.scheduler", "fifo"),
              slo=slo,
              within_d=cfg.get("serve.threshold", float("inf")),
              knn_k=cfg.get("serve.k", 10),
              device=device, tracer=tracer, metrics=metrics)
    if engine is not None:
        # an in-memory engine has no store to shard: QueryServer
        # refuses ``serve.shards`` beside it rather than ignore it
        return QueryServer(engine, shards=cfg.get("serve.shards"), **kw)
    opts = dict(engine_opts or {})
    opts.setdefault("prefetch", cfg.get("store.prefetch", True))
    return QueryServer(
        store_path=store_path, cache_bytes=cache_bytes,
        cache_policy=cfg.get("store.cache_policy", "2q"),
        pin_frac=cfg.get("store.pin_frac"),
        queue_depth=cfg.get("store.queue_depth"),
        decode_workers=cfg.get("store.decode_workers"),
        shards=cfg.get("serve.shards"),
        engine_opts=opts, **kw)


def mixed_request_stream(cfg: Config, n_nodes: int, n_requests: int,
                         rng: np.random.Generator,
                         p2p_pool: int = 16) -> List[Tuple[str, tuple]]:
    """Deterministic mixed-traffic stream from ``serve.mix`` shares:
    a list of ``(mode, args)`` submissions.  p2p pairs draw from a
    small pool so the cheap *cached* class exists (the
    millions-of-lookups traffic hub-label systems serve)."""
    mix = cfg.get("serve.mix") or {cfg.get("serve.mode", "ssd"): 1.0}
    names = sorted(mix)
    shares = np.asarray([float(mix[m]) for m in names], dtype=np.float64)
    shares /= shares.sum()
    size = max(2, p2p_pool)
    pool = rng.integers(0, n_nodes, size=(size, 2))
    if n_nodes > 1:
        # Drop self-pairs, but never to an empty pool: on tiny graphs
        # one draw can be all self-pairs.  n_nodes > 1 guarantees the
        # resample loop ends.
        kept = pool[pool[:, 0] != pool[:, 1]]
        while len(kept) == 0:
            pool = rng.integers(0, n_nodes, size=(size, 2))
            kept = pool[pool[:, 0] != pool[:, 1]]
        pool = kept
    picks = rng.choice(len(names), size=n_requests, p=shares)
    stream: List[Tuple[str, tuple]] = []
    for i in range(n_requests):
        m = names[picks[i]]
        if m == "p2p":
            s, t = pool[int(rng.integers(0, len(pool)))]
            stream.append((m, (int(s), int(t))))
        else:
            stream.append((m, (int(rng.integers(0, n_nodes)),)))
    return stream


# --------------------------------------------------------------------- CLI
async def _open_loop(server: QueryServer, requests, rate: float,
                     seed: int = 0) -> List[QueryResult]:
    """Poisson arrivals at ``rate`` req/s; returns per-request results.
    ``requests`` is an array of sources / (s, t) rows, or a
    ``mixed_request_stream`` list of ``(mode, args)`` tuples."""
    rng = np.random.default_rng(seed)
    n = len(requests)
    gaps = rng.exponential(1.0 / rate, n)
    tasks = []
    for r, gap in zip(list(requests), gaps.tolist()):
        if isinstance(r, tuple) and len(r) == 2 and isinstance(r[0], str):
            mode, args = r
            coro = server.submit(*args, mode=mode)
        elif isinstance(r, (list, np.ndarray)):
            coro = server.submit(*(int(x) for x in r))
        else:
            coro = server.submit(int(r))
        tasks.append(asyncio.create_task(coro))
        await asyncio.sleep(gap)
    await server.drain()
    return list(await asyncio.gather(*tasks))


def _frac_type(lo: float, hi: float, lo_open: bool = False):
    """argparse type: a float fraction range-checked at parse time (a
    bad --cache-frac dies here with a clear message, not inside
    PageCache)."""
    def parse(text: str) -> float:
        try:
            v = float(text)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{text!r} is not a number")
        if (v <= lo if lo_open else v < lo) or v > hi:
            bound = f"({lo}, {hi}]" if lo_open else f"[{lo}, {hi}]"
            raise argparse.ArgumentTypeError(
                f"{v:g} is out of range {bound}")
        return v
    return parse


def _nonneg_float(text: str) -> float:
    try:
        v = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not a number")
    if v < 0:
        raise argparse.ArgumentTypeError(f"{v:g} must be >= 0")
    return v


def _pos_int(text: str) -> int:
    try:
        v = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not an integer")
    if v < 1:
        raise argparse.ArgumentTypeError(f"{v} must be >= 1")
    return v


#: CLI flag -> dotted config key (the override layer, DESIGN.md §12).
_CLI_SPEC = (
    ("graph", "graph.kind"), ("side", "graph.side"),
    ("requests", "serve.requests"), ("batch", "serve.batch"),
    ("mode", "serve.mode"), ("threshold", "serve.threshold"),
    ("k", "serve.k"), ("cache", "serve.cache_entries"),
    ("rate", "serve.rate"), ("max_wait_ms", "serve.max_wait_ms"),
    ("use_pallas", "serve.use_pallas"),
    ("scheduler", "serve.scheduler"),
    ("shards", "serve.shards"),
    ("store", "store.enabled"), ("cache_frac", "store.cache_frac"),
    ("cache_policy", "store.cache_policy"), ("codec", "store.codec"),
    ("queue_depth", "store.queue_depth"),
    ("decode_workers", "store.decode_workers"),
    ("pin_frac", "store.pin_frac"),
    ("trace_out", "obs.trace_out"), ("metrics_out", "obs.metrics_out"),
)


def build_arg_parser() -> argparse.ArgumentParser:
    """The serve CLI: every config-layered flag defaults to
    ``argparse.SUPPRESS``, so only *explicitly typed* flags land in the
    override layer above the config file (the documented defaults live
    in ``SERVE_DEFAULTS``).  ``--device`` and ``--closure-limit`` are
    the port's own and sit outside the config."""
    S = argparse.SUPPRESS
    ap = argparse.ArgumentParser(
        description="batched HoD query serving on PyTorch (defaults from "
                    "repro_torch.config.SERVE_DEFAULTS; --config layers a "
                    "YAML/JSON file under any explicit flag)")
    ap.add_argument("--config", default=None,
                    help="hierarchical serve config (YAML/JSON with an "
                         "_include chain, see configs/serve_mixed.yaml);"
                         " explicit CLI flags override it")
    ap.add_argument("--graph", default=S, choices=["road", "web"])
    ap.add_argument("--side", type=_pos_int, default=S,
                    help="side of the road-grid stand-in (side^2 nodes)")
    ap.add_argument("--requests", type=_pos_int, default=S)
    ap.add_argument("--batch", type=_pos_int, default=S)
    ap.add_argument("--mode", default=S,
                    choices=["ssd", "sssp", "p2p", "threshold", "topk",
                             "knn"],
                    help="query mode (DESIGN.md §7): full SSD sweeps, "
                         "SSSP, point-to-point pairs, distance-threshold "
                         "queries, exact top-k closeness, or k-nearest "
                         "nodes per source")
    ap.add_argument("--threshold", type=_frac_type(0, float("inf"),
                                                   lo_open=True),
                    default=S, help="distance bound for --mode threshold")
    ap.add_argument("--k", type=_pos_int, default=S,
                    help="result count for --mode topk / knn")
    ap.add_argument("--sssp", action="store_true", default=S)
    ap.add_argument("--use-pallas", action="store_true", default=S,
                    help="accepted for the JAX CLI's configs; no effect "
                         "(the card runs the hand-written kernels)")
    ap.add_argument("--cache", type=int, default=S,
                    help="result-row LRU entries (0 disables)")
    ap.add_argument("--rate", type=_nonneg_float, default=S,
                    help="req/s for open-loop Poisson arrivals (0 = closed)")
    ap.add_argument("--max-wait-ms", type=_nonneg_float, default=S)
    ap.add_argument("--scheduler", default=S, choices=["fifo", "slo"],
                    help="admission policy for mixed traffic "
                         "(DESIGN.md §12): one shared fifo queue, or "
                         "per-class deadline-aware queues")
    ap.add_argument("--data-parallel", action="store_true",
                    help="split every batch's sources over the ranks "
                         "(torchrun's world, else one process; "
                         "shardlib)")
    ap.add_argument("--store", action="store_true", default=S,
                    help="serve disk-resident: save_store the index into a "
                         "temporary directory (removed on exit) and stream "
                         "it through a bounded page cache")
    ap.add_argument("--shards", type=_pos_int, default=S,
                    help="serve the store as an N-shard fleet "
                         "(DESIGN.md §13): per-shard page caches split "
                         "the --cache-frac budget, per-shard worker "
                         "pools read/decode in parallel; answers are "
                         "bit-identical to unsharded serving (implies "
                         "--store)")
    ap.add_argument("--cache-frac", type=_frac_type(0.0, 1.0,
                                                    lo_open=True),
                    default=S,
                    help="page-cache budget as a fraction in (0, 1] of the "
                         "store's DECOMPRESSED segment bytes (with --store)"
                         " — codec-independent, since the cache holds "
                         "decompressed blocks")
    ap.add_argument("--cache-policy", default=S,
                    choices=["lru", "clock", "arc", "2q"],
                    help="page-cache eviction policy (with --store); "
                         "arc/2q are scan-resistant (DESIGN.md §6)")
    ap.add_argument("--codec", default=S, choices=["raw", "delta", "f16"],
                    help="per-block segment codec (with --store): delta "
                         "compresses id streams losslessly, f16 also "
                         "narrows weights within a documented eps "
                         "(DESIGN.md §6)")
    ap.add_argument("--queue-depth", type=_pos_int, default=S,
                    help="read-pipeline depth (with --store): levels of "
                         "block reads kept in flight ahead of the sweep "
                         "(1 = no read-ahead)")
    ap.add_argument("--decode-workers", type=_pos_int, default=S,
                    help="off-thread decompression pool width (with "
                         "--store)")
    ap.add_argument("--pin-frac", type=_frac_type(0.0, 1.0), default=S,
                    help="fraction in [0, 1] of the page-cache budget "
                         "reservable by pinned core blocks (with --store; "
                         "default 0.5)")
    ap.add_argument("--no-prefetch", action="store_true", default=S,
                    help="disable the read pipeline (with --store): every "
                         "block read is synchronous")
    ap.add_argument("--trace-out", default=S,
                    help="write a per-query trace of the served run: "
                         "Chrome trace-event JSON (open in "
                         "https://ui.perfetto.dev), or a flat JSONL "
                         "event log if the path ends in .jsonl")
    ap.add_argument("--metrics-out", default=S,
                    help="write the server's metrics snapshot (counters"
                         ", gauges, latency histograms) as JSON")
    ap.add_argument("--closure-limit", type=int, default=2048,
                    help="largest core closed at build time; bigger cores "
                         "serve in bellman mode")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def load_serve_config(args: argparse.Namespace) -> Config:
    """Layer ``SERVE_DEFAULTS < --config file (+ its includes) <
    explicit CLI flags`` and validate at parse time."""
    overrides = overrides_from_args(args, _CLI_SPEC)
    if getattr(args, "no_prefetch", False):
        overrides.setdefault("store", {})["prefetch"] = False
    cfg = Config(args.config, defaults=SERVE_DEFAULTS,
                 overrides=overrides)
    return validate_serve(cfg)


def main(argv: Optional[List[str]] = None) -> ServerStats:
    """Run the CLI; returns the served run's :class:`ServerStats`."""
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    try:
        cfg = load_serve_config(args)
    except ConfigError as exc:
        ap.error(str(exc))
    sssp = getattr(args, "sssp", False)
    cli_mode = cfg.get("serve.mode", "ssd")
    if sssp and cli_mode != "ssd":
        ap.error("--sssp only combines with the default ssd mode")
    # CLI "threshold" = server mode "within"; "topk" drives the engine
    # directly through topk_closeness (a batch job, not a stream), so
    # its server runs plain ssd sweeps.
    server_mode = {"ssd": "sssp" if sssp else "ssd", "sssp": "sssp",
                   "p2p": "p2p", "threshold": "within",
                   "within": "within", "knn": "knn",
                   "topk": "ssd"}[cli_mode]
    # The server is built from the remapped mode, so the config path and
    # the CLI agree.
    cfg.data.setdefault("serve", {})["mode"] = server_mode
    if cli_mode != "topk" and not cfg.get("serve.mix"):
        cfg.data["serve"]["mix"] = {server_mode: 1.0}
    if not args.data_parallel:
        return _serve_cli(ap, args, cfg, cli_mode, server_mode, args.device)
    with distributed(args.device) as dev:
        mesh = sl.make_mesh((dist.get_world_size(),), ("data",), dev.type)
        with sl.axis_rules(mesh, {"batch": "data"}):
            if dist.get_rank() == 0:
                return _serve_cli(ap, args, cfg, cli_mode, server_mode,
                                  str(dev), rank=0)
            with contextlib.redirect_stdout(io.StringIO()):
                return _serve_cli(ap, args, cfg, cli_mode, server_mode,
                                  str(dev), rank=dist.get_rank())


#: The engine calls a served batch (or top-k closeness) makes.
_ENGINE_CALLS = ("ssd", "sssp", "p2p", "ssd_within", "knn", "ssd_bounded")


def _lead(engine, device: str) -> Callable[[], None]:
    """Rank 0 under ``--data-parallel``: each call of ``_ENGINE_CALLS``
    it makes on ``engine`` first broadcasts ``(name, args)`` to the
    other ranks (a call made inside another, as ``knn`` makes ``ssd``,
    is theirs to make too, and is not announced).  Returns the stop,
    which the caller must send (in a ``finally``)."""
    depth = [0]
    bdev = device if device.startswith("cuda") else None

    def announced(name, fn):
        def call(*args):
            if not depth[0]:
                dist.broadcast_object_list([(name, args)], src=0,
                                           device=bdev)
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return call

    for name in _ENGINE_CALLS:
        fn = getattr(engine, name, None)
        if fn is not None:
            setattr(engine, name, announced(name, fn))
    return lambda: dist.broadcast_object_list([None], src=0, device=bdev)


def _follow(engine, device: str) -> int:
    """A rank other than 0 under ``--data-parallel``: make each call
    rank 0 announces on ``engine`` (its share and the gathers), until
    the stop.  Returns the calls made."""
    bdev = device if device.startswith("cuda") else None
    calls = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0, device=bdev)
        if msg[0] is None:
            return calls
        name, args = msg[0]
        getattr(engine, name)(*args)
        calls += 1


def _serve_cli(ap, args, cfg: Config, cli_mode: str, server_mode: str,
               device: str, rank: Optional[int] = None) -> ServerStats:
    """Build the graph, index and server, and serve (``rank`` None), or
    lead (0) or follow (> 0) a data-parallel run."""
    tracer = Tracer() if cfg.get("obs.trace_out") else None

    side = int(cfg.get("graph.side"))
    g = (grid_road_graph(side) if cfg.get("graph.kind") == "road"
         else power_law_digraph(side * side, 4, weighted=True))
    print(f"graph: n={g.n} m={g.m}")
    t0 = time.perf_counter()
    res = build_hod_fast(g, BuildConfig(max_core_nodes=512,
                                        max_core_edges=1 << 15))
    ix = pack_index(g, res, chunk=2048, closure_limit=args.closure_limit,
                    device=device)
    print(f"index built in {time.perf_counter()-t0:.1f}s "
          f"({ix.n_levels} levels, core {ix.n_core}, "
          f"{res.stats.shortcuts_added} shortcuts)")
    store_dir = None
    try:
        if cfg.get("store.enabled") or cfg.get("serve.shards") is not None:
            store_dir = tempfile.mkdtemp(prefix="hod_store_")
            codec = cfg.get("store.codec")
            ix.save_store(store_dir, codec=codec)
            # budget against the DECOMPRESSED footprint: the cache
            # meters decompressed bytes, so a fraction of the compressed
            # file size would shrink the budget by the compression ratio
            frac = float(cfg.get("store.cache_frac"))
            budget = int(frac * segment_logical_bytes(store_dir))
            print(f"store: {codec} codec, "
                  f"{segment_bytes(store_dir)} bytes on disk, page cache "
                  f"{budget} bytes = {frac:.0%} of the "
                  "decompressed segments")
            server = server_from_config(
                cfg, store_path=store_dir, cache_bytes=budget,
                tracer=tracer, engine_opts={"device": device})
        else:
            server = server_from_config(
                cfg, engine=QueryEngine(ix, device=device), tracer=tracer)
    except BaseException as exc:
        # a late config error (an slo class outside the mix) must not
        # leak the just-saved temporary store
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
        if isinstance(exc, ConfigError):
            ap.error(str(exc))
        raise
    try:
        if rank:
            _follow(server.engine, device)
        else:
            stop = _lead(server.engine, device) if rank == 0 else None
            try:
                if cfg.path:
                    print(f"config: {cfg.path} "
                          f"(+{len(cfg.includes)} include(s)), scheduler "
                          f"{server.scheduler}, classes "
                          f"{', '.join(server.modes)}")
                _serve_and_report(server, cfg, cli_mode, server_mode, g.n)
            finally:
                if stop is not None:
                    stop()
    finally:
        if not rank:
            _write_outputs(server, cfg, tracer)
        server.close()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    return server.stats


def _serve_and_report(server: QueryServer, cfg: Config, cli_mode: str,
                      server_mode: str, n: int) -> None:
    eng = server.engine
    print(f"engine: {eng.device}, core_mode={eng.core_mode}")
    rng = np.random.default_rng(0)
    n_requests = int(cfg.get("serve.requests"))
    if len(server.modes) > 1:
        requests = mixed_request_stream(cfg, n, n_requests, rng)
    elif server_mode == "p2p":
        requests = rng.integers(0, n, (n_requests, 2)).astype(np.int32)
    else:
        requests = rng.integers(0, n, (n_requests,)).astype(np.int32)
    server.warmup()
    if cli_mode == "topk":
        tk = topk_closeness(eng, k=int(cfg.get("serve.k")),
                            batch_size=int(cfg.get("serve.batch")))
        print(f"top-{tk.k} closeness: {tk.batches} batches, "
              f"{tk.pruned} candidates pruned mid-sweep, "
              f"{tk.query_seconds:.2f}s")
        _print_data_parallel()
        for v, c, f in zip(tk.nodes.tolist(), tk.closeness, tk.farness):
            print(f"  node {v:>7}  closeness {c:.5f}  farness {f:.1f}")
        if server.store is not None:
            cs = server.store.cache.stats
            total = cs.hits + cs.misses
            print(f"page cache: hit rate {cs.hits / max(total, 1):.1%} "
                  f"({cs.hits} hits / {cs.misses} misses), "
                  f"{cs.bytes_read} bytes read")
        return
    rate = float(cfg.get("serve.rate", 0.0))
    if len(server.modes) > 1 and rate <= 0:
        rate = 1000.0   # mixed traffic is open-loop
    if rate > 0:
        asyncio.run(_open_loop(server, requests, rate))
    else:
        server.serve_stream(requests)
    _print_data_parallel()

    st = server.stats
    io = server.modeled_io()
    label = {"ssd": "SSD", "sssp": "SSSP", "p2p": "P2P",
             "within": f"within(d={cfg.get('serve.threshold'):g})",
             "knn": f"kNN(k={cfg.get('serve.k')})"}[server_mode]
    if len(server.modes) > 1:
        label = "+".join(server.modes)
    print(st.report(label=label, batch_size=int(cfg.get("serve.batch")),
                    latency=server.metrics.histogram(
                        f"latency_ms.{server.mode}"),
                    slo_rows=server.slo_report(),
                    fleet_stats=server.fleet_report()))
    kind = "measured" if server.store is not None else "modeled"
    io_s = io.modeled_seconds(block_bytes=server.device.block_bytes)
    print(f"{kind} disk: {io.seq_blocks} seq + {io.rand_blocks} rand "
          f"blocks, {io_s*1e3:.1f} ms total, "
          f"{io_s/max(st.requests,1)*1e3:.2f} ms/query")
    if server.store is None:
        return
    real = st.store_bytes_read
    modeled = server.modeled_scan_bytes * st.batches
    print(f"page cache: hit rate {st.page_hit_rate():.1%} "
          f"({st.page_hits} hits / {st.page_misses} misses), "
          f"{real} bytes read (real {real/1e6:.2f} MB vs modeled "
          f"{modeled/1e6:.2f} MB across {st.batches} batches)")
    if st.store_bytes_filled != real:
        print(f"codec {server.store.codec}: {real/1e6:.2f} MB compressed "
              f"read -> {st.store_bytes_filled/1e6:.2f} MB decompressed on "
              f"fill ({real/max(st.store_bytes_filled,1):.0%} ratio)")
    if eng.pipeline_stats() is not None:
        print(f"read pipeline (depth {cfg.get('store.queue_depth')}, "
              f"{cfg.get('store.decode_workers')} decode workers): modeled "
              f"stall {st.stall_seconds*1e3:.1f} ms, measured wait "
              f"{st.stall_wall_seconds*1e3:.1f} ms, time-to-first-level "
              f"{st.ttfl_seconds*1e3:.2f} ms")


def _print_data_parallel() -> None:
    """The JAX CLI's line after a data-parallel run."""
    axes = sl._live_axes("batch")
    if axes:
        print(f"data-parallel over {sl.axis_size(axes)} rank(s)")


def _write_outputs(server: QueryServer, cfg: Config, tracer) -> None:
    """``--trace-out`` (Chrome JSON, or JSONL for a ``.jsonl`` path) and
    ``--metrics-out`` (the registry's snapshot)."""
    trace_out = cfg.get("obs.trace_out")
    if tracer is not None:
        if trace_out.endswith(".jsonl"):
            tracer.write_jsonl(trace_out)
        else:
            tracer.write_chrome(trace_out)
        print(f"trace: {len(tracer.events())} events -> {trace_out}")
    metrics_out = cfg.get("obs.metrics_out")
    if metrics_out:
        with open(metrics_out, "w") as f:
            json.dump(server.metrics.snapshot(), f, indent=2)
            f.write("\n")
        print(f"metrics -> {metrics_out}")


if __name__ == "__main__":
    main()
