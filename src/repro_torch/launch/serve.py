"""Batched HoD query serving on PyTorch: the closed-loop server.

:class:`QueryServer` takes a request stream, answers repeats from an
LRU cache of recent source rows, and runs the misses through the engine
in fixed-size batches (short batches are padded by repeating the last
request, as the JAX package pads to its compiled batch shape).  Two
kinds of engine:

* ``QueryServer(engine)`` — an in-memory engine; each batch charges one
  sequential scan of the index — ``plan_f`` + core + ``plan_b`` — to
  the block-I/O model (DESIGN.md §9): every source in the batch shares
  the scan, which is the amortization HoD's sweep structure buys;
* ``QueryServer(store_path=...)`` — store-backed (DESIGN.md §6): a
  ``StreamingQueryEngine`` streams the plans from the block store
  through a page cache of ``cache_bytes`` (``cache_policy``,
  ``pin_frac``) and a read pipeline (``queue_depth``,
  ``decode_workers``); the device meters the actual block reads (cache
  misses), and ``ServerStats``/``BatchIO`` report them beside the
  modeled scan.

This is the counterpart of the JAX package's ``QueryServer`` for these
two paths: same answers, cache hits, batch and padding counts, and I/O
bytes on the same request stream.  The engine's device decides where
the sweeps run (the card unless ``--device cpu``).  The async
``submit`` path, the schedulers and sharded serving are not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --side 200 --batch 32 \\
        --closure-limit 16384
    PYTHONPATH=src python -m repro_torch.launch.serve --mode p2p --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --store \\
        --cache-frac 0.05 --codec delta --device cpu
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.build import BuildConfig
from ..core.build_fast import build_hod_fast
from ..core.graph import grid_road_graph
from ..core.index import core_scan_bytes, pack_index
from ..core.io_sim import BlockDevice, IOStats
from ..core.query import QueryEngine
from ..obs.metrics import Histogram, MetricsRegistry
from ..storage import (IndexStore, PageCache, StreamingQueryEngine,
                       segment_bytes, segment_logical_bytes)

__all__ = ["QueryResult", "ServerStats", "BatchIO", "QueryServer", "main"]


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
               latency: Optional[Histogram] = None) -> str:
        """Human-readable serving summary (the CLI footer).  ``latency``
        is the served mode's ``latency_ms.*`` histogram."""
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


class QueryServer:
    """Answers HoD query requests in fixed-size batched sweeps.

    ``mode`` picks the query type (DESIGN.md §7): ``"ssd"`` (full
    single-source distances), ``"sssp"`` (distances + predecessors),
    ``"p2p"`` (requests are ``(source, target)`` rows, answers scalar
    distances), ``"within"`` (distances clamped to ``within_d``) or
    ``"knn"`` (the ``knn_k`` nearest nodes of each source).

    ``device`` is the block-I/O model each batch's scan is charged to
    (a fresh :class:`~repro_torch.core.io_sim.BlockDevice` by default),
    as in the JAX package; the torch device is the engine's.
    ``warm_start`` runs one padded batch at construction, so kernel
    builds and first launches stay off the first request's latency.

    Pass ``store_path`` instead of ``engine`` to serve from a block
    store: the page cache holds ``cache_bytes`` of decompressed blocks
    under ``cache_policy`` (``pin_frac`` of it reservable by pins), the
    read pipeline keeps ``queue_depth`` levels in flight with
    ``decode_workers`` decoders (``None`` keeps the engine's defaults),
    and ``engine_opts`` go to the ``StreamingQueryEngine`` (its
    ``device``, ``core_mode``, ``prefetch``).  ``device`` then meters
    the store's reads.  :meth:`close` releases the segment files and
    the pipeline's threads.
    """

    MODES = ("ssd", "sssp", "p2p", "within", "knn")

    def __init__(self, engine: Optional[QueryEngine] = None,
                 batch_size: int = 32,
                 cache_entries: int = 1024, mode: str = "ssd",
                 within_d: float = float("inf"), knn_k: int = 10,
                 device: Optional[BlockDevice] = None,
                 warm_start: bool = False,
                 store_path: Optional[str] = None,
                 cache_bytes: Optional[int] = None,
                 cache_policy: str = "2q",
                 pin_frac: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 decode_workers: Optional[int] = None,
                 engine_opts: Optional[dict] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if cache_entries < 0:
            raise ValueError(f"cache_entries must be >= 0, "
                             f"got {cache_entries!r}")
        if not within_d > 0:
            raise ValueError(f"within_d must be > 0, got {within_d!r}")
        if knn_k < 1:
            raise ValueError(f"knn_k must be >= 1, got {knn_k!r}")
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r} (one of {self.MODES})")
        if queue_depth is not None and queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, "
                             f"got {queue_depth!r}")
        if decode_workers is not None and decode_workers < 1:
            raise ValueError(f"decode_workers must be >= 1, "
                             f"got {decode_workers!r}")
        if pin_frac is not None and not 0.0 <= pin_frac <= 1.0:
            raise ValueError(f"pin_frac must be in [0, 1], "
                             f"got {pin_frac!r}")
        if engine is None:
            if store_path is None:
                raise ValueError("pass an engine or a store_path")
            engine = self._store_engine(
                store_path, device, cache_bytes, cache_policy, pin_frac,
                queue_depth, decode_workers, engine_opts)
            device = engine.store.device
        elif store_path is not None:
            raise ValueError("pass either an engine or a store_path, "
                             "not both")
        self.engine = engine
        self.store = getattr(engine, "store", None)   # None = in-memory
        self.batch_io: List[BatchIO] = []
        self.batch_size = int(batch_size)
        self.cache_entries = int(cache_entries)
        self.mode = mode
        self.within_d = float(within_d)
        self.knn_k = int(knn_k)
        self.device = device or BlockDevice()
        self.metrics = MetricsRegistry()
        self.stats = ServerStats()
        self._cache: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        # One batch's disk cost = one sequential scan of the index
        # "files" (paper §5: traversal order == file order): the plans
        # the executor scans (assoc slots only when SSSP reconstruction
        # runs) plus whichever core structure core_mode reads.  A
        # store-backed server keeps it as the model its real reads are
        # compared with; only in-memory engines charge it to the device.
        sssp = mode == "sssp"
        if self.store is not None:
            self._sweep_bytes = self.store.scan_bytes(
                sssp=sssp, core_mode=engine.core_mode)
        else:
            ix = engine.index
            self._sweep_bytes = (
                ix.plan_f.scan_bytes(include_assoc=sssp)
                + ix.plan_b.scan_bytes(include_assoc=sssp)
                + (ix.plan_core.scan_bytes(True) if sssp else 0)
                + core_scan_bytes(ix, engine.core_mode))
        if warm_start:
            self.warmup()

    @staticmethod
    def _store_engine(store_path, device, cache_bytes, cache_policy,
                      pin_frac, queue_depth, decode_workers, engine_opts):
        """A ``StreamingQueryEngine`` over the store at ``store_path``
        behind a fresh page cache (DESIGN.md §6)."""
        store = IndexStore(store_path, device=device,
                           cache=PageCache(cache_bytes, policy=cache_policy,
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
    def _keys(self, requests: np.ndarray) -> List:
        """Hashable request identities: ints, or (source, target) pairs."""
        if requests.ndim == 2:
            return [(int(s), int(t)) for s, t in requests]
        return [int(s) for s in requests]

    def _cache_key(self, req) -> tuple:
        """LRU namespace: mode plus the parameter that shapes its answer
        (``within`` rows depend on the threshold, ``knn`` rows on k)."""
        if self.mode == "within":
            return (self.mode, self.within_d, req)
        if self.mode == "knn":
            return (self.mode, self.knn_k, req)
        return (self.mode, None, req)

    def _cache_get(self, req):
        key = self._cache_key(req)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
        return hit

    def _cache_put(self, req, row: tuple) -> None:
        if self.cache_entries <= 0:
            return
        key = self._cache_key(req)
        self._cache[key] = row
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_entries:
            self._cache.popitem(last=False)

    def _execute(self, requests: np.ndarray) -> List[tuple]:
        """Run one padded batch; returns one (dist, pred) row per request
        (``requests`` is ``[B]`` sources, or ``[B, 2]`` pairs in p2p)."""
        mode = self.mode
        fill = requests.shape[0]
        batch = requests
        if fill < self.batch_size:     # pad to the fixed batch shape
            pad = ((0, self.batch_size - fill),) + ((0, 0),) * (
                requests.ndim - 1)
            batch = np.pad(requests, pad, mode="edge")
        before = (self.store.cache.stats.snapshot()
                  if self.store is not None else None)
        pstats = (self.engine.pipeline_stats()
                  if self.store is not None else None)
        pbefore = pstats.snapshot() if pstats is not None else None
        t0 = time.perf_counter()
        if mode == "sssp":
            dist, pred = self.engine.sssp(batch)
        elif mode == "p2p":
            dist, pred = self.engine.p2p(batch[:, 0], batch[:, 1]), None
        elif mode == "within":
            dist, pred = self.engine.ssd_within(batch, self.within_d), None
        elif mode == "knn":
            # rows carry (distances, node ids); _row_fields unpacks
            pred, dist = self.engine.knn(batch, self.knn_k)
        else:
            dist, pred = self.engine.ssd(batch), None
        busy = time.perf_counter() - t0   # answers are on the host here
        self.stats.busy_seconds += busy
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
        if self.store is None:
            # No real reads happen: charge the modeled sequential scan.
            self.device.sequential(self._sweep_bytes)
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
                modeled_bytes=self._sweep_bytes, page_hits=delta.hits,
                page_misses=delta.misses, filled_bytes=delta.bytes_filled,
                stall_s=pdelta.stall_model_s if pdelta else 0.0))
            m.counter("page_cache.hits").inc(delta.hits)
            m.counter("page_cache.misses").inc(delta.misses)
            m.counter("store.bytes_read").inc(delta.bytes_read)
            m.counter("store.bytes_filled").inc(delta.bytes_filled)
            m.gauge("page_cache.hit_rate").set(st.page_hit_rate())
        rows = []
        for i, req in enumerate(self._keys(requests)):
            if mode == "p2p":          # scalar answer per pair
                row = (np.float32(dist[i]), None)
            else:
                row = (dist[i].copy(),
                       None if pred is None else pred[i].copy())
            self._cache_put(req, row)
            rows.append(row)
        return rows

    def _observe(self, latency_s: float, cached: bool) -> None:
        """Per-request metrics: the request counter and the per-mode
        (``.cached`` / ``.cold``) latency histograms."""
        m = self.metrics
        m.counter("server.requests").inc()
        ms = latency_s * 1e3
        m.histogram(f"latency_ms.{self.mode}").observe(ms)
        if cached:
            m.counter("server.result_cache_hits").inc()
            m.histogram(f"latency_ms.{self.mode}.cached").observe(ms)
        else:
            m.histogram(f"latency_ms.{self.mode}.cold").observe(ms)

    def _row_fields(self, row: tuple) -> tuple:
        """Split a cached row into ``(dist, pred, nodes)`` — knn rows
        carry node ids in the second slot, SSSP rows predecessors."""
        if self.mode == "knn":
            return row[0], None, row[1]
        return row[0], row[1], None

    # --------------------------------------------------------------- serving
    def warmup(self) -> None:
        """Run one padded batch outside the latency path (kernel builds,
        first launches, allocator growth), then zero every counter, the
        row cache and the I/O model.  A store-backed server keeps the
        warmed blocks resident (what a warm start buys) and zeroes the
        page cache's, the device's and the pipeline's counters under the
        cache's lock, in one reset."""
        shape = (1, 2) if self.mode == "p2p" else (1,)
        self._execute(np.zeros(shape, dtype=np.int32))
        self.stats = ServerStats()
        self.batch_io.clear()
        self._cache.clear()   # the warmup row must not count as a hit
        if self.store is not None:
            also = [self.device.reset]
            ps = self.engine.pipeline_stats()
            if ps is not None:
                also.append(ps.reset)
            self.store.cache.reset_stats(also=also)
        else:
            self.device.reset()
        self.metrics.reset()

    def serve_stream(self, requests: np.ndarray) -> List[QueryResult]:
        """Closed-loop serving: answer a request list in arrival order.

        ``requests`` is ``[N]`` sources — or ``[N, 2]`` (source, target)
        rows in p2p mode.  All requests of a chunk arrive together, so
        each one's ``latency_s`` is the full chunk wall time — divide by
        ``batched_with`` for the amortized per-query cost.
        """
        mode = self.mode
        requests = np.asarray(requests, dtype=np.int32)
        if (requests.ndim == 2) != (mode == "p2p"):
            raise ValueError("p2p mode takes [N, 2] (source, target) "
                             "rows; other modes take [N] sources")
        out: List[QueryResult] = []
        for lo in range(0, requests.shape[0], self.batch_size):
            chunk = requests[lo: lo + self.batch_size]
            t0 = time.perf_counter()
            hit_rows = {k: self._cache_get(k) for k in self._keys(chunk)}
            misses = sorted(k for k, row in hit_rows.items() if row is None)
            miss_rows: Dict[object, tuple] = {}
            if misses:
                uniq = np.asarray(misses, dtype=np.int32)
                for k, row in zip(misses, self._execute(uniq)):
                    miss_rows[k] = row
            lat = time.perf_counter() - t0
            share = self._sweep_bytes / len(misses) if misses else 0.0
            charged = set()   # charge each missed request's share once
            for k in self._keys(chunk):
                cached = k not in miss_rows
                # A hit evicted by this chunk's own misses (a cache
                # smaller than the chunk) is answered from its snapshot.
                row = miss_rows.get(k) or self._cache_get(k) or hit_rows[k]
                self.stats.requests += 1
                self.stats.cache_hits += cached
                self._observe(lat, cached)
                src, tgt = k if isinstance(k, tuple) else (k, None)
                d, p, nd = self._row_fields(row)
                out.append(QueryResult(
                    source=src, target=tgt, dist=d, pred=p, nodes=nd,
                    mode=mode, latency_s=lat, batched_with=chunk.shape[0],
                    cached=cached,
                    io_bytes=0.0 if (cached or k in charged) else share))
                charged.add(k)
        return out

    # ------------------------------------------------------------- reporting
    @property
    def modeled_scan_bytes(self) -> int:
        """Compact-payload cost of one full index scan."""
        return self._sweep_bytes

    def modeled_io(self) -> IOStats:
        """The I/O model's counters: the synthetic per-batch scan charge
        (in-memory), or the store's actual block reads."""
        return self.device.stats

    def close(self) -> None:
        """Release the store's segment files and the pipeline's threads
        (store-backed; nothing to release in memory)."""
        if self.store is not None:
            self.engine.close()


# --------------------------------------------------------------------- CLI
def _frac(lo: float, lo_open: bool):
    """argparse type: a float in ``(lo, 1]`` (``lo_open``) or
    ``[lo, 1]``."""
    def parse(text: str) -> float:
        x = float(text)
        if not (lo < x <= 1.0 if lo_open else lo <= x <= 1.0):
            raise argparse.ArgumentTypeError(
                f"must be in {'(' if lo_open else '['}{lo:g}, 1], "
                f"got {text}")
        return x
    return parse


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="batched HoD query serving on PyTorch (closed loop; "
                    "in memory, or streamed from a block store)")
    ap.add_argument("--side", type=int, default=60,
                    help="side of the road-grid stand-in (side^2 nodes)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--mode", default="ssd",
                    choices=["ssd", "sssp", "p2p", "threshold", "knn"])
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="distance bound for --mode threshold")
    ap.add_argument("--k", type=int, default=10,
                    help="result count for --mode knn")
    ap.add_argument("--closure-limit", type=int, default=2048,
                    help="largest core closed at build time; bigger cores "
                         "serve in bellman mode")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--store", action="store_true",
                    help="serve disk-resident: save_store the index into a "
                         "temporary directory (removed on exit) and stream "
                         "it through a bounded page cache")
    ap.add_argument("--cache-frac", type=_frac(0.0, True), default=0.25,
                    help="page-cache budget as a fraction in (0, 1] of the "
                         "store's DECOMPRESSED segment bytes (with --store)"
                         " — codec-independent, since the cache holds "
                         "decompressed blocks")
    ap.add_argument("--cache-policy", default="2q",
                    choices=["lru", "clock", "arc", "2q"],
                    help="page-cache eviction policy (with --store); "
                         "arc/2q are scan-resistant (DESIGN.md §6)")
    ap.add_argument("--codec", default="raw", choices=["raw", "delta", "f16"],
                    help="per-block segment codec (with --store): delta "
                         "compresses id streams losslessly, f16 also "
                         "narrows weights within a documented eps "
                         "(DESIGN.md §6)")
    ap.add_argument("--queue-depth", type=int, default=4,
                    help="read-pipeline depth (with --store): levels of "
                         "block reads kept in flight ahead of the sweep "
                         "(1 = no read-ahead)")
    ap.add_argument("--decode-workers", type=int, default=2,
                    help="off-thread decompression pool width (with "
                         "--store)")
    ap.add_argument("--pin-frac", type=_frac(0.0, False), default=None,
                    help="fraction in [0, 1] of the page-cache budget "
                         "reservable by pinned core blocks (with --store; "
                         "default 0.5)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the read pipeline (with --store): every "
                         "block read is synchronous")
    return ap


def main(argv: Optional[List[str]] = None) -> ServerStats:
    """Run the CLI; returns the served run's :class:`ServerStats`."""
    args = build_arg_parser().parse_args(argv)
    for flag in ("side", "requests", "batch", "k", "queue_depth",
                 "decode_workers"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1")
    server_mode = {"threshold": "within"}.get(args.mode, args.mode)
    g = grid_road_graph(args.side)
    print(f"graph: n={g.n} m={g.m}")
    t0 = time.perf_counter()
    res = build_hod_fast(g, BuildConfig(max_core_nodes=512,
                                        max_core_edges=1 << 15))
    ix = pack_index(g, res, chunk=2048, closure_limit=args.closure_limit,
                    device=args.device)
    print(f"index built in {time.perf_counter()-t0:.1f}s "
          f"({ix.n_levels} levels, core {ix.n_core}, "
          f"{res.stats.shortcuts_added} shortcuts)")
    opts = dict(batch_size=args.batch, mode=server_mode,
                within_d=args.threshold, knn_k=args.k)
    store_dir = None
    try:
        if args.store:
            store_dir = tempfile.mkdtemp(prefix="hod_store_")
            ix.save_store(store_dir, codec=args.codec)
            # budget against the DECOMPRESSED footprint: the cache
            # meters decompressed bytes, so a fraction of the compressed
            # file size would shrink the budget by the compression ratio
            budget = int(args.cache_frac * segment_logical_bytes(store_dir))
            print(f"store: {args.codec} codec, "
                  f"{segment_bytes(store_dir)} bytes on disk, page cache "
                  f"{budget} bytes = {args.cache_frac:.0%} of the "
                  "decompressed segments")
            server = QueryServer(
                store_path=store_dir, cache_bytes=budget,
                cache_policy=args.cache_policy, pin_frac=args.pin_frac,
                queue_depth=args.queue_depth,
                decode_workers=args.decode_workers,
                engine_opts={"device": args.device,
                             "prefetch": not args.no_prefetch},
                warm_start=True, **opts)
        else:
            server = QueryServer(QueryEngine(ix, device=args.device),
                                 warm_start=True, **opts)
        try:
            _serve_and_report(server, args, server_mode, g.n)
        finally:
            server.close()
    finally:
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    return server.stats


def _serve_and_report(server: QueryServer, args, server_mode: str,
                      n: int) -> None:
    eng = server.engine
    print(f"engine: {eng.device}, core_mode={eng.core_mode}")
    rng = np.random.default_rng(0)
    shape = (args.requests, 2) if server_mode == "p2p" else (args.requests,)
    requests = rng.integers(0, n, shape).astype(np.int32)
    server.serve_stream(requests)

    st = server.stats
    io = server.modeled_io()
    label = {"ssd": "SSD", "sssp": "SSSP", "p2p": "P2P",
             "within": f"within(d={args.threshold:g})",
             "knn": f"kNN(k={args.k})"}[server_mode]
    print(st.report(label=label, batch_size=args.batch,
                    latency=server.metrics.histogram(
                        f"latency_ms.{server.mode}")))
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
        print(f"read pipeline (depth {args.queue_depth}, "
              f"{args.decode_workers} decode workers): modeled stall "
              f"{st.stall_seconds*1e3:.1f} ms, measured wait "
              f"{st.stall_wall_seconds*1e3:.1f} ms, time-to-first-level "
              f"{st.ttfl_seconds*1e3:.2f} ms")


if __name__ == "__main__":
    main()
