"""Queue-depth-N async read pipeline with off-thread decompression
(DESIGN.md §6).

The JAX package's ``storage/pipeline.py``, with its tracer hooks and
its fleet routing.  It is plain Python: no worker thread here ever
touches a tensor, let alone one on the card.

The sweep visits a segment's levels in a fixed order (the paper's §4
sequential-scan invariant), which makes deep read-ahead safe:
:class:`ReadPipeline` keeps up to ``queue_depth`` levels' block reads
in flight — submit/reap with ordered completion over the modeled
:class:`~repro_torch.core.io_sim.BlockDevice` — and runs codec CPU work
(CRC verify, delta varint decode, f16 widening) on a
``decode_workers``-wide worker pool, so a fill never blocks the query
thread::

    query thread        submit_level(): per-block cache transaction
      (submit)          (hit/miss/eviction/pin/byte counters) AND the
                        modeled-device charge via
                        PageCache.begin_fill(charge=...) — a
                        PendingBlock of the known decoded size is
                        admitted at once; contiguous missed-block runs
                        become one batched extent pread job
    io thread (1)       ordered preads (SegmentReader.read_frames);
      (read)            hands each frame to...
    decode pool (M)     CRC verify + codec decode
      (decode)          (SegmentReader.decode_frame), completing the
                        PendingBlock in place; a corrupt frame is
                        discarded from the cache and the error
                        re-raises in whichever thread waits

**Fleet routing.** When the store belongs to a ``ServingFleet``
(``store.fleet``), the pipeline runs on the shards' pools instead of
its own: a level's missed-block runs split at ownership boundaries, and
each shard's runs go to its 1-wide io pool and its decode pool, so the
shards read and decode side by side.  Cache transactions stay on the
query thread in submit order (the routing façade forwards each to the
owning shard's cache), so the counters are those of one host.

**Determinism.** Every counter mutation — cache *and* modeled device —
happens at submit time on the query thread, in the block order the
synchronous path uses, so hit/miss/eviction/``bytes_read`` and
seq/random-block sequences are the same at every queue depth (the
``bytes_read`` and device charges use the frame table's ``comp_len``,
known before the read happens).  Charging the device inside
``begin_fill``'s lock also makes the compound stats reset atomic
(``PageCache.reset_stats(also=[device.reset, pipeline.stats.reset])``).
The price: a read that then *fails* has already been charged — the
fault path only.  Only payload materialization is asynchronous; the
slabs are byte-identical, and so are the answers.

**Tracing** (DESIGN.md §11): given a ``tracer``, each submitted level
draws a span id that stitches its story across threads — a
``pipe.submit`` span (synthetic ``submit`` track, so the query
thread's own sequence stays the same at every depth), a ``level.read``
span on the io thread, ``level.decode`` spans on the decode pool, and a
``level.wait`` span around the reaper's collect.  ``tracer=None``
leaves every hook one attribute check.

**Stall accounting.** Per reaped level the pipeline records the
measured consumer time and the level's *modeled* device time (an
``IOStats`` delta around its reads — deterministic), then runs a small
discrete-event simulation of the one-spindle device under the submit
window "level *i* may start once level *i − depth* was reaped":
``stall_model_s`` is the modeled time the consumer would wait on the
device, comparable across queue depths because the modeled I/O is the
same.  ``stall_wall_s`` is the measured wait and ``ttfl_s`` the
measured time-to-first-level of the first sweep since the last reset.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

from ..core.io_sim import IOStats
from ..obs.trace import span_if
from .pagecache import PendingBlock

__all__ = ["PipelineStats", "ReadPipeline"]


@dataclasses.dataclass
class PipelineStats:
    levels: int = 0             # levels reaped
    submitted: int = 0          # levels submitted
    stall_model_s: float = 0.0  # modeled consumer wait on the device
    stall_wall_s: float = 0.0   # measured wait for in-flight fills
    compute_s: float = 0.0      # measured consumer time between reaps
    ttfl_s: float = 0.0         # time-to-first-level, first sweep since reset

    def snapshot(self) -> "PipelineStats":
        return dataclasses.replace(self)

    def reset(self) -> None:
        """Zero every counter in place (the pipeline holds a reference
        to this object, so callers reset rather than replace it)."""
        self.__init__()

    def __sub__(self, other: "PipelineStats") -> "PipelineStats":
        return PipelineStats(self.levels - other.levels,
                             self.submitted - other.submitted,
                             self.stall_model_s - other.stall_model_s,
                             self.stall_wall_s - other.stall_wall_s,
                             self.compute_s - other.compute_s,
                             self.ttfl_s - other.ttfl_s)


class _LevelTicket:
    """One submitted level: its cache entries (bytes or in-flight
    :class:`PendingBlock` placeholders), the modeled seconds of the
    reads it caused on each shard's device (computed at submit time,
    before the ticket is visible to any other thread; length 1 on a
    solo store, empty for a zero-row level), and the trace span id
    stitching its read/decode/wait events together."""

    __slots__ = ("seg", "name", "lvl", "skip", "entries", "io_s",
                 "span_id")

    def __init__(self, seg, lvl: int, entries: list, skip: int,
                 name: str = "", span_id: int = 0):
        self.seg, self.lvl, self.skip = seg, lvl, skip
        self.name = name
        self.entries = entries
        self.io_s = ()
        self.span_id = span_id

    def collect(self):
        """Wait for every entry, assemble + parse the slab.  Returns
        ``(slab, measured_wait_seconds)``; re-raises a failed fill."""
        t0 = time.perf_counter()
        parts = [e.wait() if isinstance(e, PendingBlock) else e
                 for e in self.entries]
        stall_wall = time.perf_counter() - t0
        buf = self.seg.clip_level(b"".join(parts), self.lvl, self.skip)
        return self.seg.parse_slab(buf, self.lvl), stall_wall

    def drain(self) -> None:
        """Wait out in-flight fills, swallowing their errors — the
        abandon path (the consumer already has its exception; an
        in-flight failure must not be lost *or* raised twice)."""
        for e in self.entries:
            if isinstance(e, PendingBlock):
                try:
                    e.wait()
                except Exception:
                    pass


class ReadPipeline:
    """Submit/reap pipeline over one :class:`IndexStore`'s segments.

    One pipeline serves one sweep at a time (the engine's levels are
    strictly ordered); ``submit_level`` must be called from the query
    thread — that is what keeps cache accounting deterministic — and
    ``reap`` in submission order.
    """

    def __init__(self, store, queue_depth: int = 4,
                 decode_workers: int = 2, tracer=None):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if decode_workers < 1:
            raise ValueError("decode_workers must be >= 1")
        self.store = store
        self.tracer = tracer
        self.queue_depth = int(queue_depth)
        self.decode_workers = int(decode_workers)
        self.stats = PipelineStats()
        # A fleet's store brings its own per-shard worker pools and
        # devices, which outlive this pipeline (the fleet shuts them
        # down with the store); a solo store's pools are owned here.
        fleet = store.fleet
        if fleet is not None:
            self._io_pools = [s.io for s in fleet.shards]
            self._decode_pools = [s.decode for s in fleet.shards]
            self._devs = [s.device for s in fleet.shards]
            self._owner = fleet.owner_of_key
        else:
            self._io_pools = [ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hod-pipe-io")]
            self._decode_pools = [ThreadPoolExecutor(
                max_workers=self.decode_workers,
                thread_name_prefix="hod-pipe-decode")]
            self._devs = [store.device]
            self._owner = None
        self._owns_pools = fleet is None
        self._inflight: List = []   # io futures, waited out on close
        self.begin_sweep()

    # ------------------------------------------------------------ lifecycle
    def begin_sweep(self) -> None:
        """Reset the per-sweep stall simulation (virtual clocks start
        at the sweep's first submit; the device timeline does not carry
        across sweeps)."""
        self._sim_t = 0.0           # consumer virtual time
        # busy-until virtual time of each shard's device (one solo)
        self._sim_dev = [0.0] * len(self._devs)
        self._reap_virtual: List[float] = []
        now = time.perf_counter()
        self._sweep_t0 = now
        self._last_reap_wall = now
        self._first_reap = True

    def close(self) -> None:
        if self._owns_pools:
            for pool in self._io_pools + self._decode_pools:
                pool.shutdown(wait=True)
            return
        # The fleet's pools keep running: wait out this pipeline's jobs
        # (their errors are already in the placeholders).
        for f in self._inflight:
            if not f.done():
                f.exception()
        self._inflight = []

    # --------------------------------------------------------------- submit
    def submit_level(self, name: str, lvl: int,
                     pin: bool = False) -> _LevelTicket:
        """Submit one level's block reads (query thread).  Runs the
        whole per-block cache transaction now — in block order — and
        enqueues one batched pread per contiguous missed-block run."""
        seg = self.store.segments[name]
        self.stats.submitted += 1
        tr = self.tracer
        sid = tr.new_id() if tr is not None else 0
        if seg.version >= 4 and seg.extents[lvl][1] == 0:
            return _LevelTicket(seg, lvl, [], 0, name=name,
                                span_id=sid)   # zero-row level
        b0, b1, skip = seg._level_blocks(lvl)
        pin = pin or seg.pin_blocks
        dev = seg.device
        snaps = [(d.stats.seq_blocks, d.stats.rand_blocks)
                 for d in self._devs]
        entries: list = []
        # [(shard, b_lo, [(block, key, holder), ...])]: a run breaks at
        # a gap in the block numbers or at a change of owner, so each
        # run is one pread against one shard's extent.
        runs: list = []
        route = self._owner
        with span_if(tr, "pipe.submit", track="submit", plan=name,
                     level=lvl, span=sid, blocks=b1 - b0 + 1):
            for b in range(b0, b1 + 1):
                key = (seg._cache_ns, b)
                size, disk = seg.frame_info(b)
                entry, owner = self.store.cache.begin_fill(
                    key, size, disk, pin=pin,
                    charge=(lambda b=b, d=disk:
                            dev.access_block(seg.base_block + b, d)))
                entries.append(entry)
                if owner:
                    shard = route(key) if route is not None else 0
                    if (runs and runs[-1][0] == shard
                            and runs[-1][2][-1][0] == b - 1):
                        runs[-1][2].append((b, key, entry))
                    else:
                        runs.append((shard, b, [(b, key, entry)]))
        ticket = _LevelTicket(seg, lvl, entries, skip, name=name,
                              span_id=sid)
        ticket.io_s = tuple(
            IOStats(seq_blocks=d.stats.seq_blocks - s0,
                    rand_blocks=d.stats.rand_blocks - r0
                    ).modeled_seconds(block_bytes=dev.block_bytes)
            for d, (s0, r0) in zip(self._devs, snaps))
        by_shard: dict = {}
        for shard, b_lo, owned in runs:
            by_shard.setdefault(shard, []).append((b_lo, owned))
        for shard, shard_runs in by_shard.items():
            self._inflight.append(self._io_pools[shard].submit(
                self._read_job, seg, ticket, shard_runs,
                self._decode_pools[shard]))
        return ticket

    def _read_job(self, seg, ticket: _LevelTicket, runs: list,
                  decode_pool: ThreadPoolExecutor) -> None:
        """io thread (a shard's, or the pipeline's own): batched extent
        preads, then fan the frames out to ``decode_pool``.  Cache and
        device accounting already happened at submit time — this thread
        only moves bytes."""
        try:
            decode_jobs = []
            with span_if(self.tracer, "level.read", plan=ticket.name,
                         level=ticket.lvl, parent=ticket.span_id,
                         runs=len(runs)):
                for b_lo, owned in runs:
                    try:
                        raw = seg.read_frames(b_lo, owned[-1][0])
                    except Exception as exc:
                        for _b, key, holder in owned:
                            self.store.cache.discard(key, holder)
                            holder.fail(exc)
                        continue
                    for b, key, holder in owned:
                        decode_jobs.append(
                            (seg, b, key, holder,
                             seg.frame_slice(raw, b_lo, b)))
            for job in decode_jobs:
                decode_pool.submit(self._decode_job, *job,
                                   ticket.span_id)
        except BaseException as exc:
            # Never leave a holder unset: every waiter would deadlock.
            for _b_lo, owned in runs:
                for _b, key, holder in owned:
                    if holder.data is None and holder.error is None:
                        self.store.cache.discard(key, holder)
                        holder.fail(exc)
            raise

    def _decode_job(self, seg, block: int, key, holder: PendingBlock,
                    raw: bytes, span_id: int = 0) -> None:
        """decode pool: CRC verify + codec decode, completing the
        placeholder.  A corrupt frame is dropped from the cache and the
        error re-raises in the waiting query thread."""
        with span_if(self.tracer, "level.decode", block=block,
                     parent=span_id):
            try:
                data = seg.decode_frame(block, raw)
            except BaseException as exc:
                self.store.cache.discard(key, holder)
                holder.fail(exc)
            else:
                holder.set(data)

    # ----------------------------------------------------------------- reap
    def reap(self, ticket: _LevelTicket):
        """Reap the oldest in-flight level (submission order): wait for
        its fills, parse the slab, and advance the stall simulation."""
        t0 = time.perf_counter()
        compute = t0 - self._last_reap_wall
        with span_if(self.tracer, "level.wait", plan=ticket.name,
                     level=ticket.lvl, span=ticket.span_id):
            slab, stall_wall = ticket.collect()
        # Discrete-event model of the spindles under the depth-N submit
        # window (module docstring), one busy-until clock a shard's
        # device: a level is in once its slowest shard's reads land.
        i = len(self._reap_virtual)
        self._sim_t += compute
        window = (self._reap_virtual[i - self.queue_depth]
                  if i >= self.queue_depth else 0.0)
        io_v = ticket.io_s or (0.0,) * len(self._sim_dev)
        self._sim_dev = [max(sd, window) + io
                         for sd, io in zip(self._sim_dev, io_v)]
        stall = max(0.0, max(self._sim_dev) - self._sim_t)
        self._sim_t += stall
        self._reap_virtual.append(self._sim_t)
        st = self.stats
        st.levels += 1
        st.compute_s += compute
        st.stall_model_s += stall
        st.stall_wall_s += stall_wall
        self._last_reap_wall = time.perf_counter()
        if self._first_reap:
            self._first_reap = False
            if st.ttfl_s == 0.0:
                st.ttfl_s = self._last_reap_wall - self._sweep_t0
        return slab

    def drain(self, tickets) -> None:
        """Abandon path: wait out every in-flight ticket's fills so no
        error is lost and no placeholder is left incomplete (a later
        cache hit on one would otherwise wait forever)."""
        for t in tickets:
            t.drain()
        self._inflight = [f for f in self._inflight if not f.done()]
