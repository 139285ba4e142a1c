"""Store-backed streaming query execution (DESIGN.md §6) on PyTorch.

:class:`StreamingQueryEngine` answers the same batched queries as
:class:`~repro_torch.core.query.QueryEngine` but never holds a whole
:class:`~repro_torch.core.index.SweepPlan`: each sweep walks its segment
file level by level, pulling one slab at a time through the store's
page cache.  A distance level is packed on the host by
:func:`~repro_torch.kernels.edge_relax.sweep.pack_level` (one row per
destination, finite slots only — the rule of the in-memory engine's
``pack_sweep``), moved to the card in one copy through the engine's
two pinned buffers (:class:`~repro_torch.kernels.edge_relax.sweep
.PinnedStager`), and relaxed by one ``edge_relax`` launch.  The other
level bodies (SSSP reconstruction, the P2P backward labels) run on the
level's rows through :meth:`QueryEngine._run_plan_stream`, in plain
torch as in the in-memory engine.  Peak plan memory on the device is
one level, and the ``IOStats`` of the store's
:class:`~repro_torch.core.io_sim.BlockDevice` record the block reads the
queries caused (cache misses), not a synthetic charge.

This is the JAX package's ``storage/stream.py`` on node-major labels
(``[n_pad, S]``), with the same public methods, answers and block
reads: the level bodies are those of the in-memory engine, applied to
the same levels in the same order, and min is exact in any order.  The
order of reads is the reference's:

* SSSP pins the levels its distance pass streams (``PageCache`` pin
  leases, bounded by the pin budget) and reconstructs in the order
  ``plan_b → plan_core → plan_f``, unpinning each level after use; the
  per-plan max-merges commute, so predecessors equal the in-memory
  ``f → core → b`` order's.  A ``finally`` releases leftover leases,
  also when a sweep raises.
* ``prefetch=True`` streams each full sweep through the depth-N
  :class:`~repro_torch.storage.pipeline.ReadPipeline` (reads and
  decodes on worker threads, every cache transaction on the query
  thread in submit order), so hit/miss/byte sequences are the same at
  every depth and with ``prefetch=False``.  Fill failures (a CRC
  mismatch on a corrupt segment) surface in the querying thread, and
  the level generator drains in-flight fills when a sweep is abandoned.
* The bounded sweeps (P2P, threshold, kNN, the top-k prune) read
  synchronously, so a skipped level skips its device I/O.

With a tracer (:meth:`StreamingQueryEngine.set_tracer`) the engine
emits the reference's events: the pipeline's spans, ``level.read`` on
a synchronous read, ``level.relax`` around each level of a full sweep
(a distance level's pack, staging and launch; a reconstruction level's
upload and body), ``core.search``, and the cache and device instants on
the synthetic ``submit`` and ``device`` tracks.  The bounded sweeps
relax their levels without a ``level.relax`` span, as the reference's
do.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.index import node_levels
from ..core.query import INF, QueryEngine, _knn_select
from ..kernels.edge_relax import relax_sweep_
from ..kernels.edge_relax.sweep import PinnedStager, pack_level
from ..obs.trace import span_if
from .blockfile import IndexStore
from .pipeline import PipelineStats, ReadPipeline

__all__ = ["StreamingQueryEngine", "StreamTimes"]


@dataclasses.dataclass
class StreamTimes:
    """Host seconds of the streamed levels, summed: ``read_s`` getting
    each level's slab from the store (the pipeline's submit and reap
    wait, or a synchronous read; reconstruction levels too), and for
    the ``levels`` distance levels ``pack_s`` packing one, ``upload_s``
    staging it through the pinned buffers (the wait for a buffer
    included), ``launch_s`` the ``edge_relax`` call (on the CPU, the
    relaxation itself)."""

    levels: int = 0
    read_s: float = 0.0
    pack_s: float = 0.0
    upload_s: float = 0.0
    launch_s: float = 0.0

    def reset(self) -> None:
        self.__init__()


class StreamingQueryEngine(QueryEngine):
    """Batched queries over an :class:`IndexStore`, one level slab at a
    time, on ``device`` (``"cuda"`` by default, or ``"cpu"``).

    Supports ``core_mode`` ``"closure"`` and ``"bellman"`` (the core
    searches over the resident tier, on the device) and ``"dijkstra"``
    (host heap over the resident core CSR).  The resident tier —
    permutations, core closure/CSR — stays in memory; the three plan
    segments stream.
    """

    def __init__(self, store: IndexStore, core_mode: str = "closure",
                 eps: float = 0.0, prefetch: bool = True,
                 queue_depth: int = 4, decode_workers: int = 2,
                 device=None, tracer=None):
        self.store = store
        #: the ServingFleet when the store is sharded (``fleet/``),
        #: surfaced so that servers report per-shard stats without
        #: reaching through storage internals
        self.fleet = store.fleet
        self.prefetch = bool(prefetch)
        self._init_engine(store.resident, core_mode, eps, device)
        self._stager = PinnedStager(self.device)
        self.times = StreamTimes()
        self._pipe = (ReadPipeline(store, queue_depth=queue_depth,
                                   decode_workers=decode_workers)
                      if self.prefetch else None)
        if tracer is not None:
            self.set_tracer(tracer)

    # --------------------------------------------------------- observability
    def set_tracer(self, tracer) -> None:
        """Attach a :class:`repro_torch.obs.trace.Tracer` (DESIGN.md §11)
        to every layer this engine drives: the level spans, the
        pipeline's submit/read/decode/wait spans, the cache's
        hit/miss/evict instants (``PageCache.on_event``, on the
        synthetic ``submit`` track so that the query thread's own span
        sequence is the same at every queue depth) and the modeled
        device's reads (``BlockDevice.on_access``, ``device`` track).
        ``None`` detaches everything."""
        self.tracer = tracer
        self._seg_short: dict = {}   # cache namespace -> short label
        if self._pipe is not None:
            self._pipe.tracer = tracer
        self.store.cache.on_event = (self._on_cache_event
                                     if tracer is not None else None)
        self.store.device.on_access = (self._on_device_access
                                       if tracer is not None else None)

    def _on_cache_event(self, kind: str, key, nbytes: int) -> None:
        tr = self.tracer
        if tr is None:
            return
        if isinstance(key, tuple) and len(key) == 2:
            ns, block = key
            seg = self._seg_short.get(ns)
            if seg is None:   # memoized: this fires per block touch
                seg = self._seg_short[ns] = os.path.basename(str(ns))
            block = int(block)
        else:
            seg, block = str(key), -1
        tr.instant(f"cache.{kind}", track="submit", seg=seg,
                   block=block, bytes=int(nbytes))

    def _on_device_access(self, block_id: int, nbytes: int,
                          seq: bool) -> None:
        tr = self.tracer
        if tr is not None:
            tr.instant("device.read", track="device",
                       block=int(block_id), bytes=int(nbytes),
                       seq=bool(seq))

    def pipeline_stats(self) -> Optional[PipelineStats]:
        """The live :class:`PipelineStats` (overlap/stall metrics), or
        ``None`` when running synchronously (``prefetch=False``)."""
        return self._pipe.stats if self._pipe is not None else None

    # ------------------------------------------------------------- streaming
    def _levels(self, name: str, pin: bool = False,
                unpin_after: bool = False) -> Iterator[tuple]:
        """Yield one plan's level slabs in scan order.

        ``pin=True`` takes a pin lease on every block read (the
        distance pass of an SSSP query); ``unpin_after=True`` releases
        a level's leases right after the consumer finishes with it
        (the reconstruction pass).  With the pipeline, up to
        ``queue_depth`` levels stay in flight: each reap tops the
        window back up before waiting, and reaping re-raises fill
        errors in the querying thread.  The ``finally`` drains every
        in-flight ticket when the consumer abandons the sweep, so a
        failed fill is never silently lost and no placeholder is left
        incomplete.
        """
        n = self.store.n_real(name)
        times = self.times
        if self._pipe is None:
            for lvl in range(n):
                t0 = time.perf_counter()
                with span_if(self.tracer, "level.read", plan=name,
                             level=lvl):
                    slab = self.store.read_level(name, lvl, pin=pin)
                times.read_s += time.perf_counter() - t0
                yield slab
                if unpin_after:
                    self.store.unpin_level(name, lvl)
            return
        pipe = self._pipe
        pipe.begin_sweep()
        tickets: "deque" = deque()
        nxt = 0

        def top_up():
            nonlocal nxt
            while nxt < n and len(tickets) < pipe.queue_depth:
                tickets.append(pipe.submit_level(name, nxt, pin=pin))
                nxt += 1

        try:
            top_up()
            for lvl in range(n):
                t0 = time.perf_counter()
                ticket = tickets.popleft()
                top_up()
                slab = pipe.reap(ticket)
                times.read_s += time.perf_counter() - t0
                yield slab
                if unpin_after:
                    self.store.unpin_level(name, lvl)
        finally:
            pipe.drain(tickets)

    def _read(self, name: str, lvl: int) -> tuple:
        """One level slab, read synchronously (the bounded sweeps bypass
        the pipeline so that a skip or an early exit provably skips the
        I/O, not just the compute)."""
        t0 = time.perf_counter()
        with span_if(self.tracer, "level.read", plan=name, level=lvl):
            slab = self.store.read_level(name, lvl)
        self.times.read_s += time.perf_counter() - t0
        return slab

    def _relax_slab(self, dist: torch.Tensor, slab: tuple,
                    d=None) -> torch.Tensor:
        """One distance level, in place: packed, staged, one
        ``edge_relax`` launch on CUDA.  With a bound ``d`` (a float, or
        a ``[1, S]`` radius) every label past it is snapped back to
        ``+inf`` after the level (DESIGN.md §7)."""
        dst, src_idx, w, _assoc, valid = slab
        times, stager = self.times, self._stager
        staged = stager.stage_s
        t0 = time.perf_counter()
        sweep = pack_level((dst, src_idx, w, valid), self.index.n_pad,
                           stager)
        t1 = time.perf_counter()
        relax_sweep_(dist, sweep)
        t2 = time.perf_counter()
        del sweep
        upload = stager.stage_s - staged
        times.levels += 1
        times.pack_s += t1 - t0 - upload
        times.upload_s += upload
        times.launch_s += t2 - t1
        if d is not None:
            dist.masked_fill_(~(dist <= d), INF)
        return dist

    def _sweep(self, dist: torch.Tensor, name: str,
               pin: bool = False) -> torch.Tensor:
        """A full distance sweep of one plan, with a ``level.relax``
        span (``plan``, ``level``) around each level's pack, staging and
        launch, where the reference's streamed level step has it."""
        for lvl, slab in enumerate(self._levels(name, pin=pin)):
            with span_if(self.tracer, "level.relax", plan=name,
                         level=lvl):
                dist = self._relax_slab(dist, slab)
        return dist

    def _core_search(self, dist: torch.Tensor) -> torch.Tensor:
        """The engine's core search, inside a ``core.search`` span."""
        if not self.index.n_core:
            return dist
        with span_if(self.tracer, "core.search", mode=self.core_mode):
            return super()._core_search(dist)

    def _ssd_stream(self, sources_perm: np.ndarray,
                    pin: bool = False) -> torch.Tensor:
        dist = self._sweep(self._init_state(sources_perm), "plan_f", pin)
        return self._sweep(self._core_search(dist), "plan_b", pin)

    def _unpin_plan(self, name: str) -> None:
        """Release every pin lease a distance sweep may still hold on
        one plan's levels (idempotent; sticky segment pins unaffected)."""
        for lvl in range(self.store.n_real(name)):
            self.store.unpin_level(name, lvl)

    # ---------------------------------------------------------------- public
    def ssd(self, sources: np.ndarray) -> np.ndarray:
        return self._to_host(self._ssd_stream(self._perm_ids(sources)))

    def sssp(self, sources: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        try:
            # The distance pass pins the levels it streams:
            # reconstruction re-reads all of them right after.
            dist = self._ssd_stream(self._perm_ids(sources), pin=True)
            pred = torch.full(dist.shape, -1, dtype=torch.int32,
                              device=self.device)
            recon = self._recon_level_body(dist)
            # Reverse plan order for cache affinity: plan_b was streamed
            # moments ago, plan_f a whole sweep ago (the pinned one).
            # The per-plan scatter-maxes commute.
            for name in ("plan_b", "plan_core", "plan_f"):
                pred = self._run_plan_stream(
                    pred, self._levels(name, unpin_after=True), recon,
                    self._stager, label=name)
        finally:
            for name in ("plan_f", "plan_b"):
                self._unpin_plan(name)
        return self._to_host(dist), self._to_host(pred)

    # -------------------------------------------- bounded sweeps (§7)
    @staticmethod
    def _range_live(dist: torch.Tensor, lo: int, hi: int) -> bool:
        """Whether any label of nodes ``[lo, hi)`` is finite."""
        return bool(torch.isfinite(dist[lo:hi]).any())

    @staticmethod
    def _suffix_min(fwd: torch.Tensor, cut: int) -> torch.Tensor:
        """Per-column min of the labels of nodes ``>= cut`` (``+inf``
        where there are none)."""
        if cut >= fwd.shape[0]:
            return torch.full((fwd.shape[1],), INF, device=fwd.device)
        return fwd[cut:].amin(dim=0)

    def p2p(self, sources: np.ndarray, targets: np.ndarray,
            early_term: bool = True) -> np.ndarray:
        """Point-to-point distances ``dist(sources[i], targets[i])`` by
        meet-in-the-middle (DESIGN.md §7), reading less than a full SSD
        sweep:

        * the forward half skips every ``plan_f`` level below the
          lowest source level (labels there are provably still +inf);
        * the backward-label half walks ``plan_b`` in *reverse* scan
          order (ascending rank), skips its tail below the lowest
          target level, and — with ``early_term`` — stops as soon as
          every column's best meeting distance is <= the suffix-min of
          its (final) forward labels over the ids later levels can
          still touch: backward labels are nonnegative, so no later
          meet can beat the bound.  ``early_term=False`` reads every
          kept level; the answers are the same either way.
        """
        ix = self.index
        src_perm, tgt_perm = self._perm_ids(sources), self._perm_ids(targets)
        lvl_s = int(node_levels(ix, src_perm).min())
        lvl_t = int(node_levels(ix, tgt_perm).min())

        fwd = self._init_state(src_perm)
        start_f = int(np.searchsorted(self._level_ids_f, lvl_s,
                                      side="left"))
        for lvl in range(start_f, self.store.n_real("plan_f")):
            fwd = self._relax_slab(fwd, self._read("plan_f", lvl))
        fwd = self._core_search(fwd)

        bwd = self._init_state(tgt_perm)
        best = (fwd + bwd).amin(dim=0)
        keep = np.nonzero(self._level_ids_b >= lvl_t)[0]
        for j in (range(int(keep.max()), -1, -1) if keep.size else ()):
            bwd = self._run_plan_stream(bwd, [self._read("plan_b", j)],
                                        self._relax_level_rev,
                                        self._stager)
            best = (fwd + bwd).amin(dim=0)
            if early_term and j > 0:
                cut = int(ix.level_ptr[int(self._level_ids_b[j - 1])])
                if bool((best <= self._suffix_min(fwd, cut)).all()):
                    break
        return best.cpu().numpy()

    def ssd_within(self, sources: np.ndarray, d: float) -> np.ndarray:
        """All distances ``<= d`` (the rest ``+inf``), original node
        order.

        Labels past ``d`` are clamped after every level, so a level
        whose *gather range* holds no finite label is provably inert —
        the sweep skips its reads.  Forward level ``g`` gathers its own
        level's ids ``[level_ptr[g], level_ptr[g+1])``; backward level
        ``g`` gathers the higher ranks ``>= level_ptr[g+1]``.
        """
        lp = self.index.level_ptr
        d = float(np.float32(d))
        dist = self._init_state(self._perm_ids(sources))
        dist.masked_fill_(~(dist <= d), INF)   # d < 0: nothing survives
        for lvl in range(self.store.n_real("plan_f")):
            g = int(self._level_ids_f[lvl])
            if self._range_live(dist, int(lp[g]), int(lp[g + 1])):
                dist = self._relax_slab(dist, self._read("plan_f", lvl), d)
        dist = self._core_search(dist)
        dist.masked_fill_(~(dist <= d), INF)   # mask the core output
        for lvl in range(self.store.n_real("plan_b")):
            g = int(self._level_ids_b[lvl])
            if self._range_live(dist, int(lp[g + 1]), dist.shape[0]):
                dist = self._relax_slab(dist, self._read("plan_b", lvl), d)
        return self._to_host(dist)

    def knn(self, sources: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray]:
        """The ``k`` nearest nodes of each source (DESIGN.md §7): a
        threshold sweep whose per-column radius shrinks.

        Before each level the radius is the column's kth-smallest
        current label (``kthvalue``, a selection, so exact) — labels
        only decrease, so it bounds the final kth distance, and clamping
        labels past it is sound by :meth:`ssd_within`'s argument.
        Levels whose gather range holds no live label are skipped,
        reads included.  Returns ``(nodes, dist)``, each ``[S, k]`` in
        original node ids, ascending ``(distance, node id)`` with the
        source itself at distance 0; rows with fewer than ``k``
        reachable nodes pad with ``(-1, +inf)``.
        """
        ix = self.index
        if not 1 <= k <= ix.n:
            raise ValueError(f"k must be in [1, {ix.n}], got {k}")
        lp = ix.level_ptr
        dist = self._init_state(self._perm_ids(sources))

        def clamp(d):
            r = d.kthvalue(k, dim=0, keepdim=True).values      # [1, S]
            return d.masked_fill_(~(d <= r), INF), r

        for lvl in range(self.store.n_real("plan_f")):
            g = int(self._level_ids_f[lvl])
            dist, r = clamp(dist)
            if self._range_live(dist, int(lp[g]), int(lp[g + 1])):
                dist = self._relax_slab(dist, self._read("plan_f", lvl), r)
        dist = self._core_search(dist)
        for lvl in range(self.store.n_real("plan_b")):
            g = int(self._level_ids_b[lvl])
            dist, r = clamp(dist)
            if self._range_live(dist, int(lp[g + 1]), dist.shape[0]):
                dist = self._relax_slab(dist, self._read("plan_b", lvl), r)
        return _knn_select(self._to_host(dist), k)

    @staticmethod
    def _far_slice(dist: torch.Tensor, lo: int, hi: int) -> np.ndarray:
        """Per-source farness contribution of perm ids ``[lo, hi)``,
        summed on the host in float64 over a contiguous ``[S, hi-lo]``
        copy — the reference's array and order, so integer-valued
        distances accumulate exactly and a prune decision never
        differs."""
        d = dist[lo:hi].t().contiguous().cpu().numpy()
        return np.where(np.isfinite(d), d, 0.0).sum(axis=1,
                                                    dtype=np.float64)

    def ssd_bounded(self, sources: np.ndarray, threshold: float
                    ) -> Tuple[Optional[np.ndarray], bool]:
        """SSD that may abandon mid-backward-sweep once every source's
        farness provably exceeds ``threshold`` (the top-k closeness
        prune, DESIGN.md §7).

        The backward sweep finalizes labels level by level descending:
        after the level at graph level ``g``, every id ``>=
        level_ptr[g]`` is final.  The running sum of finite finalized
        distances is therefore a lower bound on each source's farness;
        when it exceeds ``threshold`` for every source the remaining
        levels go unread.  Returns ``(dist_in_original_order, True)``
        for a completed sweep — equal to :meth:`ssd` — or
        ``(None, False)``.
        """
        ix = self.index
        lp = ix.level_ptr
        dist = self._init_state(self._perm_ids(sources))
        for lvl in range(self.store.n_real("plan_f")):
            dist = self._relax_slab(dist, self._read("plan_f", lvl))
        dist = self._core_search(dist)
        nb = self.store.n_real("plan_b")
        if nb:
            cut = int(lp[int(self._level_ids_b[0]) + 1])
            far = self._far_slice(dist, cut, dist.shape[0])
            if np.all(far > threshold):
                return None, False
            for lvl in range(nb):
                dist = self._relax_slab(dist, self._read("plan_b", lvl))
                new_cut = int(lp[int(self._level_ids_b[lvl])])
                far += self._far_slice(dist, new_cut, cut)
                cut = new_cut
                if lvl + 1 < nb and np.all(far > threshold):
                    return None, False
        return self._to_host(dist), True

    def close(self) -> None:
        """Stop the pipeline's threads and close the segment files."""
        if self._pipe is not None:
            self._pipe.close()
        self.store.close()
