"""Bounded-byte page cache over block-file segments (DESIGN.md §6).

A copy of the JAX package's ``storage/pagecache.py`` (plain Python,
no array library): the same policies, pins and counters, so a store
served by either package makes the same cache transactions.

The store's unit of I/O is one fixed-size block of a segment file
(`storage/blockfile.py`); the cache's unit of residency is the same
block.  :class:`PageCache` keeps at most ``capacity_bytes`` of blocks
resident and answers every block fetch either from memory (*hit* — no
device charge) or by invoking the caller's loader (*miss* — the loader
reads the block from the segment file and meters it through the shared
:class:`~repro_torch.core.io_sim.BlockDevice`, so ``IOStats`` reflects actual
bytes read).  Format-v5 codec segments *decompress on fill*: the loader
hands back the decompressed block together with the compressed byte
count it read, so the byte budget and residency meter **decompressed**
(usable) bytes while ``bytes_read``/``IOStats`` meter the
**compressed** bytes that actually moved — the hit-rate-vs-budget
tradeoff that a store's codec trades on (DESIGN.md §6).

Four eviction policies:

* ``"lru"`` (default) — strict least-recently-used order;
* ``"clock"`` — second-chance/CLOCK: a hit sets the block's reference
  bit instead of moving it, and the eviction hand skips (and clears)
  referenced blocks once before evicting;
* ``"arc"`` / ``"2q"`` — *scan-resistant* policies for the cyclic
  sweep workload (DESIGN.md §6).  Plain LRU/CLOCK retain **nothing**
  across a sweep whose block footprint exceeds the budget (the classic
  cyclic-scan thrash: every block is evicted moments before it would
  be re-read), so partial budgets buy a 0% hit rate.  Both policies
  here share the same scan-resistant skeleton:

  - **warm fill** — while the budget has free room, cold blocks enter
    the *main* region.  Once full, the main region is frozen against
    scans: a cold block can never evict main-region residents.
  - **window** — cold blocks arriving at a full cache enter a small
    FIFO *window* (``WINDOW_FRAC`` of the budget, always keeping the
    most recent block) that only evicts within itself.  The window
    serves the short-range re-references the affinity block layout
    creates (adjacent levels sharing a boundary block) without letting
    a once-per-sweep scan touch the main region.
  - **ghost-gated admission** — window victims leave a *ghost* (key
    only, no data).  Only a block re-referenced while its ghost is
    live is admitted into the main region, evicting per policy.  On a
    pure cyclic scan the ghosts roll over before the cycle returns,
    so the frozen prefix is never eroded and every sweep re-hits it.

  They differ in the main region itself: ``"2q"`` keeps one LRU list
  (2Q's ``Am``; the window is its ``A1in``, the ghost list its
  ``A1out``), while ``"arc"`` keeps ARC's ``T1``/``T2`` split with
  dual ghost lists ``B1``/``B2`` and the adaptive target ``p``
  (byte-weighted: a ``B1`` ghost hit grows ``p`` by the block's size,
  a ``B2`` hit shrinks it).  These are deliberate deviations from the
  textbook formulations — textbook ARC and full-2Q both degrade to
  LRU-like 0% retention on a cyclic scan larger than the cache (cold
  misses never form ghosts / ghost lists roll over), which is exactly
  the regime this store lives in.  The deltas are documented in
  DESIGN.md §6 and locked in by the trace-driven reference models in
  ``tests/test_cache_policies.py``.

**Pinning** (segment-aware admission, DESIGN.md §6): ``get(...,
pin=True)`` moves the block into a pinned region that eviction never
touches, bounded by ``pin_frac`` of the budget (requests beyond the
pin budget degrade to normal caching — never an error).  The store
pins the small ``plan_core`` segment resident so once-per-sweep
``plan_f`` scans can never evict it, and SSSP reconstruction pins the
levels the distance pass just touched (they are immediately re-read);
:meth:`unpin` releases blocks back to the main region's MRU position.

The cache is shared by every segment of a store and by the read
pipeline (`storage/stream.py` / `storage/pipeline.py`), so all state —
residency map, byte budget, counters — is guarded by one lock.  On the
synchronous :meth:`get` path the lock is *held across the loader
call*: concurrent queries serialize on disk reads, which keeps budget
enforcement exact (resident bytes never exceed ``capacity_bytes``,
pinned included) and matches the one-spindle device model.

**Pipelined fills** (:meth:`begin_fill`, DESIGN.md §6): the async read
pipeline admits a :class:`PendingBlock` placeholder *before* the read
happens — decoded block sizes are known ahead of time (always
``block_bytes``), so every cache-state transition (hit/miss counting,
admission, eviction, pinning, byte metering) runs on the query thread
at submit time, in exactly the block order the synchronous path would
use.  Only the payload (pread + CRC + codec decode, off-thread) is
asynchronous: the worker completes the placeholder in place, and any
consumer — the pipeline's level tickets, or a synchronous :meth:`get`
hit racing an in-flight fill — waits on it *outside* the lock.  Hit /
miss / eviction / ``bytes_read`` sequences are therefore bit-identical
at every queue depth, including depth 1 and the no-pipeline path.  A
failed fill (CRC mismatch) is :meth:`discard`-ed by the worker and the
error re-raises in every waiting thread.

**Observability hook** (DESIGN.md §11): setting :attr:`on_event` to a
callable ``(kind, key, nbytes)`` reports every ``"hit"`` / ``"miss"``
/ ``"evict"`` transition, fired *under the lock* at the exact point
the counters move — so the event order equals the counter order, and
the cross-depth determinism contract extends to the event stream.
The hook must be cheap and must never call back into the cache (the
tracer's buffered ``instant`` qualifies).  ``None`` (default)
disables it at the cost of one attribute check.

**Atomic resets**: pipelined fills charge the shared
:class:`~repro_torch.core.io_sim.BlockDevice` through :meth:`begin_fill`'s
``charge`` callback — under this same lock — and
:meth:`reset_stats`'s ``also=`` callbacks (device reset, pipeline
stats reset) run under it too, so a compound stats reset can never
land *between* a cache counter and its paired device charge, even
with fills in flight.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Hashable, Iterable, Optional

__all__ = ["CacheStats", "PageCache", "PendingBlock", "POLICIES"]

POLICIES = ("lru", "clock", "arc", "2q")


class PendingBlock:
    """Placeholder for a block whose fill is in flight (pipelined read).

    The decoded size is known up front, so the placeholder occupies the
    block's budget immediately (``len()`` reports it); the payload
    arrives later via :meth:`set` (or :meth:`fail`, which re-raises the
    fill error in every waiter).  The object stays in the cache after
    completion — lookups transparently :meth:`wait` on it."""

    __slots__ = ("size", "data", "error", "_done")

    def __init__(self, size: int):
        self.size = int(size)
        self.data: Optional[bytes] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def __len__(self) -> int:
        return self.size

    def set(self, data: bytes) -> None:
        self.data = data
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self._done.set()

    def wait(self) -> bytes:
        """Block until the fill completes; re-raise a failed fill."""
        self._done.wait()
        if self.error is not None:
            raise self.error
        return self.data


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_read: int = 0     # actual "disk" bytes loaders consumed
    peak_bytes: int = 0     # high-water mark of resident bytes
    ghost_hits: int = 0     # misses whose key had a live ghost (arc/2q)
    bytes_filled: int = 0   # decompressed bytes handed back by loaders
    pinned_bytes: int = 0   # gauge: bytes currently pinned resident

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __sub__(self, other: "CacheStats") -> "CacheStats":
        """Counter delta (for per-batch reporting); the gauges (peak,
        pinned bytes) are kept as-is."""
        return CacheStats(self.hits - other.hits,
                          self.misses - other.misses,
                          self.evictions - other.evictions,
                          self.bytes_read - other.bytes_read,
                          self.peak_bytes,
                          self.ghost_hits - other.ghost_hits,
                          self.bytes_filled - other.bytes_filled,
                          self.pinned_bytes)

    def __add__(self, other: "CacheStats") -> "CacheStats":
        """Aggregation over several caches: counters sum; the
        gauges sum too — the fleet-wide peak/pinned figure is the sum
        of per-shard residency highs (an upper bound on simultaneous
        residency, the budget-accounting side callers care about)."""
        return CacheStats(self.hits + other.hits,
                          self.misses + other.misses,
                          self.evictions + other.evictions,
                          self.bytes_read + other.bytes_read,
                          self.peak_bytes + other.peak_bytes,
                          self.ghost_hits + other.ghost_hits,
                          self.bytes_filled + other.bytes_filled,
                          self.pinned_bytes + other.pinned_bytes)

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self)


class PageCache:
    """Block cache with a hard byte budget and four eviction policies.

    ``capacity_bytes=None`` means unbounded (everything read stays
    resident — the 100%-of-index serving regime); ``capacity_bytes=0``
    disables caching entirely (every fetch is a miss).  A single block
    larger than the whole budget is returned to the caller but never
    cached.  See the module docstring for the ``"arc"``/``"2q"`` state
    machines and the pinning protocol.
    """

    #: fraction of the budget the scan-resistant policies reserve for
    #: the cold-block window (at least the most recent block is always
    #: kept, even when one block exceeds the window share).
    WINDOW_FRAC = 0.125
    #: default fraction of the budget pinned blocks may occupy; pin
    #: requests beyond it degrade to normal (unpinned) caching.  The
    #: per-instance knob is the ``pin_frac`` constructor arg.
    PIN_FRAC = 0.5

    def __init__(self, capacity_bytes: Optional[int] = None,
                 policy: str = "lru", pin_frac: Optional[float] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown eviction policy: {policy!r}")
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0 or None")
        pin_frac = self.PIN_FRAC if pin_frac is None else float(pin_frac)
        if not 0.0 <= pin_frac <= 1.0:
            raise ValueError("pin_frac must be in [0, 1]")
        self.capacity_bytes = capacity_bytes
        self.policy = policy
        self.pin_frac = pin_frac
        self.stats = CacheStats()
        #: optional observer ``(kind, key, nbytes)`` for hit/miss/evict
        #: transitions (module docstring); fired under the lock.
        self.on_event: Optional[Callable[[str, Hashable, int], None]] = \
            None
        self._lock = threading.Lock()
        # lru/clock primary store: key -> bytes, order per policy
        self._blocks: "collections.OrderedDict[Hashable, bytes]" = \
            collections.OrderedDict()
        self._ref: dict = {}        # CLOCK reference bits
        self._bytes = 0             # bytes in _blocks
        # arc/2q regions (head of each OrderedDict evicts first)
        self._win: "collections.OrderedDict[Hashable, bytes]" = \
            collections.OrderedDict()   # cold-block FIFO window
        self._t1: "collections.OrderedDict[Hashable, bytes]" = \
            collections.OrderedDict()   # ARC T1 (warm fill / seen once)
        self._t2: "collections.OrderedDict[Hashable, bytes]" = \
            collections.OrderedDict()   # ARC T2 / 2Q Am (main LRU)
        self._win_bytes = self._t1_bytes = self._t2_bytes = 0
        self._b1: "collections.OrderedDict[Hashable, int]" = \
            collections.OrderedDict()   # ghosts: key -> block size
        self._b2: "collections.OrderedDict[Hashable, int]" = \
            collections.OrderedDict()
        self._b1_bytes = self._b2_bytes = 0
        self._p = 0.0               # ARC adaptive T1 target (bytes)
        # pinned region: excluded from eviction, counted in the budget
        self._pinned: "collections.OrderedDict[Hashable, bytes]" = \
            collections.OrderedDict()
        self._pinned_bytes = 0

    # ------------------------------------------------------------- interface
    def get(self, key: Hashable, load: Callable[[], bytes],
            pin: bool = False) -> bytes:
        """Return the block for ``key``, loading (and caching) on a miss.

        The loader may return either the block ``bytes``, or a
        ``(bytes, disk_bytes)`` pair when filling costs fewer disk
        bytes than it yields — a codec segment's decompress-on-fill
        (DESIGN.md §6): the *decompressed* block is what gets cached
        (so the byte budget meters resident, usable bytes) while
        ``stats.bytes_read`` advances by the *compressed* bytes the
        loader actually read.  ``stats.bytes_filled`` always meters the
        decompressed side.

        ``pin=True`` additionally pins the block (hit or miss) if the
        pin budget allows; pinned blocks are never evicted until
        :meth:`unpin` releases them.

        A hit on a :class:`PendingBlock` (a fill the read pipeline has
        in flight) waits for that fill *outside* the lock and re-raises
        its error, so synchronous traffic composes with pipelined fills
        without double-reading or double-charging.
        """
        with self._lock:
            data = self._peek_hit(key)
            if data is not None:
                self.stats.hits += 1
                if self.on_event is not None:
                    self.on_event("hit", key, len(data))
                if pin:
                    self._try_pin(key)
            else:
                self.stats.misses += 1
                loaded = load()
                if isinstance(loaded, tuple):
                    data, disk_bytes = loaded
                else:
                    data, disk_bytes = loaded, len(loaded)
                self.stats.bytes_read += disk_bytes
                self.stats.bytes_filled += len(data)
                if self.on_event is not None:
                    self.on_event("miss", key, disk_bytes)
                self._admit(key, data, pin)
                self.stats.peak_bytes = max(self.stats.peak_bytes,
                                            self._resident())
                return data
        if isinstance(data, PendingBlock):
            return data.wait()
        return data

    def begin_fill(self, key: Hashable, size: int, disk_bytes: int,
                   pin: bool = False,
                   charge: Optional[Callable[[], None]] = None):
        """Pipelined-fill admission (the read pipeline's submit step).

        Returns ``(entry, owner)``.  On a hit, ``entry`` is the
        resident value (``bytes`` or an in-flight :class:`PendingBlock`)
        and ``owner`` is False.  On a miss, a fresh
        :class:`PendingBlock` of the (known) decoded ``size`` is
        admitted *now* — counters (``bytes_read`` advances by the
        compressed ``disk_bytes``, ``bytes_filled`` by ``size``),
        evictions and pinning all happen here on the calling thread,
        exactly as a synchronous :meth:`get` miss would — and ``owner``
        is True: the caller must read+decode the block and complete the
        placeholder with ``entry.set(data)`` (or ``entry.fail(exc)``
        after :meth:`discard`).  Determinism contract: calling this in
        block order yields hit/miss/eviction/byte sequences
        bit-identical to the synchronous path, at any queue depth.

        ``charge`` (miss only) runs under the lock right after the byte
        counters move — the pipeline charges the shared block device
        here, so the device and cache counters advance *atomically*
        (exactly like the synchronous path, whose loader runs under
        this lock) and a concurrent :meth:`reset_stats` can never split
        them.
        """
        with self._lock:
            data = self._peek_hit(key)
            if data is not None:
                self.stats.hits += 1
                if self.on_event is not None:
                    self.on_event("hit", key, len(data))
                if pin:
                    self._try_pin(key)
                return data, False
            self.stats.misses += 1
            self.stats.bytes_read += disk_bytes
            self.stats.bytes_filled += size
            if charge is not None:
                charge()
            if self.on_event is not None:
                self.on_event("miss", key, disk_bytes)
            holder = PendingBlock(size)
            self._admit(key, holder, pin)
            self.stats.peak_bytes = max(self.stats.peak_bytes,
                                        self._resident())
            return holder, True

    def discard(self, key: Hashable, entry: "PendingBlock") -> None:
        """Drop a failed pipelined fill (decode worker error path): if
        ``entry`` is still what ``key`` resolves to, remove it so later
        traffic re-reads the block instead of re-raising forever.  Call
        *before* ``entry.fail(exc)``."""
        with self._lock:
            if self._pinned.get(key) is entry:
                self._pinned.pop(key)
                self._pinned_bytes -= len(entry)
                self.stats.pinned_bytes = self._pinned_bytes
                return
            region = self._find_region(key)
            if region is None or region[key] is not entry:
                return
            region.pop(key)
            size = len(entry)
            if region is self._blocks:
                self._bytes -= size
                self._ref.pop(key, None)
            elif region is self._win:
                self._win_bytes -= size
            elif region is self._t1:
                self._t1_bytes -= size
            else:
                self._t2_bytes -= size

    def pin(self, key: Hashable) -> bool:
        """Pin an already-resident block (no-op miss). True if pinned."""
        with self._lock:
            if key in self._pinned:
                return True
            if self._find_region(key) is None:
                return False
            return self._try_pin(key)

    def unpin(self, keys: Iterable[Hashable]) -> None:
        """Release pinned blocks back into the main region (MRU end).

        Unknown / never-pinned keys are ignored, so callers can unpin a
        whole level's key list without tracking which pins stuck.
        """
        with self._lock:
            for key in keys:
                data = self._pinned.pop(key, None)
                if data is None:
                    continue
                self._pinned_bytes -= len(data)
                if self.policy in ("lru", "clock"):
                    self._blocks[key] = data
                    self._bytes += len(data)
                    self._ref[key] = True
                else:                       # arc/2q: main-region MRU
                    self._t2[key] = data
                    self._t2_bytes += len(data)
            self.stats.pinned_bytes = self._pinned_bytes

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident()

    @property
    def pinned_bytes(self) -> int:
        with self._lock:
            return self._pinned_bytes

    def pinned_keys(self):
        with self._lock:
            return list(self._pinned.keys())

    def resident_keys(self):
        """Keys currently cached, in eviction order (head evicts first);
        pinned keys (never evicted) come last."""
        with self._lock:
            if self.policy in ("lru", "clock"):
                keys = list(self._blocks.keys())
            else:
                keys = (list(self._win.keys()) + list(self._t1.keys())
                        + list(self._t2.keys()))
            return keys + list(self._pinned.keys())

    def clear(self) -> None:
        with self._lock:
            for d in (self._blocks, self._ref, self._win, self._t1,
                      self._t2, self._b1, self._b2, self._pinned):
                d.clear()
            self._bytes = self._win_bytes = self._t1_bytes = 0
            self._t2_bytes = self._b1_bytes = self._b2_bytes = 0
            self._pinned_bytes = 0
            self.stats.pinned_bytes = 0
            self._p = 0.0

    def reset_stats(self, also: Iterable[Callable[[], object]] = ()
                    ) -> CacheStats:
        """Zero the counters (cache contents stay resident; the
        pinned-bytes gauge carries over).

        ``also`` callbacks (device reset, pipeline-stats reset) run
        *under the cache lock*, making the compound reset atomic with
        respect to in-flight fills: every fill charges its cache
        counters and its device bytes under this same lock
        (:meth:`get`'s loader, :meth:`begin_fill`'s ``charge``), so a
        reset can never land between the two halves of a charge and
        leave the device/cache byte invariant drifted.
        """
        with self._lock:
            out, self.stats = self.stats, CacheStats(
                pinned_bytes=self._pinned_bytes)
            for fn in also:
                fn()
            return out

    # ------------------------------------------------------------- internals
    def _resident(self) -> int:
        if self.policy in ("lru", "clock"):
            return self._bytes + self._pinned_bytes
        return (self._win_bytes + self._t1_bytes + self._t2_bytes
                + self._pinned_bytes)

    def _win_cap(self) -> int:
        cap = self.capacity_bytes
        return 0 if cap is None else max(1, int(cap * self.WINDOW_FRAC))

    def _pin_cap(self) -> Optional[int]:
        cap = self.capacity_bytes
        return None if cap is None else int(cap * self.pin_frac)

    def _find_region(self, key: Hashable):
        for d in (self._blocks, self._win, self._t1, self._t2):
            if key in d:
                return d
        return None

    def _peek_hit(self, key: Hashable) -> Optional[bytes]:
        """Resident lookup + the policy's on-hit transition."""
        data = self._pinned.get(key)
        if data is not None:
            return data
        if self.policy == "lru":
            data = self._blocks.get(key)
            if data is not None:
                self._blocks.move_to_end(key)
            return data
        if self.policy == "clock":
            data = self._blocks.get(key)
            if data is not None:
                self._ref[key] = True
            return data
        # arc / 2q
        data = self._win.get(key)
        if data is not None:
            if self.policy == "arc":    # window re-reference: refresh only
                self._win.move_to_end(key)
            return data                 # 2q: A1in hit leaves FIFO order
        data = self._t1.get(key)
        if data is not None:            # ARC: T1 hit promotes to T2
            del self._t1[key]
            self._t1_bytes -= len(data)
            self._t2[key] = data
            self._t2_bytes += len(data)
            return data
        data = self._t2.get(key)
        if data is not None:
            self._t2.move_to_end(key)
            return data
        return None

    def _try_pin(self, key: Hashable) -> bool:
        """Move a resident block into the pinned region (budget allowing)."""
        region = self._find_region(key)
        if region is None:
            return False
        size = len(region[key])
        pin_cap = self._pin_cap()
        if pin_cap is not None and self._pinned_bytes + size > pin_cap:
            return False
        data = region.pop(key)
        if region is self._blocks:
            self._bytes -= size
            self._ref.pop(key, None)
        elif region is self._win:
            self._win_bytes -= size
        elif region is self._t1:
            self._t1_bytes -= size
        else:
            self._t2_bytes -= size
        self._pinned[key] = data
        self._pinned_bytes += size
        self.stats.pinned_bytes = self._pinned_bytes
        return True

    # ---------------------------------------------------------- admission
    def _admit(self, key: Hashable, data: bytes, pin: bool) -> None:
        cap = self.capacity_bytes
        size = len(data)
        if cap == 0:
            return                      # caching disabled
        if cap is not None and size > cap - self._pinned_bytes:
            return                      # cannot fit even alone: don't cache
        if pin:
            pin_cap = self._pin_cap()
            if pin_cap is None or self._pinned_bytes + size <= pin_cap:
                self._unghost(key)
                self._pinned[key] = data
                self._pinned_bytes += size
                self.stats.pinned_bytes = self._pinned_bytes
                self._shrink_for_pin(cap)
                return
            # pin budget exhausted: fall through to normal admission
        if self.policy in ("lru", "clock"):
            self._blocks[key] = data
            self._ref[key] = False      # fresh blocks start unreferenced
            self._bytes += size
            if cap is not None:
                while self._resident() > cap:
                    before = self._bytes
                    self._evict_one_legacy(keep=key)
                    if self._bytes == before:   # nothing evictable left
                        break
            return
        if self.policy == "arc":
            self._admit_arc(key, data, cap)
        else:
            self._admit_2q(key, data, cap)
        self._trim_ghosts(cap)

    def _admit_arc(self, key: Hashable, data: bytes, cap) -> None:
        size = len(data)
        if key in self._b1 or key in self._b2:
            # ghost hit: earn main-region admission, adapt p (bytes)
            self.stats.ghost_hits += 1
            if key in self._b1:
                if cap is not None:
                    self._p = min(float(cap), self._p + size)
            else:
                self._p = max(0.0, self._p - size)
            self._unghost(key)
            self._t2[key] = data
            self._t2_bytes += size
            self._shrink_main(cap, keep=key)
        elif self._main_has_room(size, cap):
            self._t1[key] = data        # warm fill
            self._t1_bytes += size
        else:
            self._win[key] = data       # cold at full: window only
            self._win_bytes += size
            self._shrink_window(cap, keep=key)

    def _admit_2q(self, key: Hashable, data: bytes, cap) -> None:
        size = len(data)
        if key in self._b1:             # A1out ghost hit -> Am
            self.stats.ghost_hits += 1
            self._unghost(key)
            self._t2[key] = data
            self._t2_bytes += size
            self._shrink_main(cap, keep=key)
        elif self._main_has_room(size, cap):
            self._t2[key] = data        # warm fill straight into Am
            self._t2_bytes += size
        else:
            self._win[key] = data       # cold at full: A1in window only
            self._win_bytes += size
            self._shrink_window(cap, keep=key)

    def _main_has_room(self, size: int, cap) -> bool:
        if cap is None:
            return True
        main = self._t1_bytes + self._t2_bytes + self._pinned_bytes
        # Reserve the window's actual occupancy when it exceeds its
        # share (a lone block larger than the share is never trimmed),
        # so a warm fill can never push the total over the budget.
        reserved = max(self._win_cap(), self._win_bytes)
        return main + size <= cap - reserved

    # ----------------------------------------------------------- eviction
    def _unghost(self, key: Hashable) -> None:
        """Drop any ghost entry for ``key`` (a key is never resident and
        ghosted at once, and never in both ghost lists)."""
        if key in self._b1:
            self._b1_bytes -= self._b1.pop(key)
        if key in self._b2:
            self._b2_bytes -= self._b2.pop(key)

    def _ghost(self, ghosts, key: Hashable, size: int) -> None:
        self._unghost(key)
        ghosts[key] = size
        if ghosts is self._b1:
            self._b1_bytes += size
        else:
            self._b2_bytes += size

    def _evict_window(self, keep: Optional[Hashable]) -> bool:
        """Drop the window's oldest entry (never ``keep``) to a B1 ghost."""
        for victim in self._win:
            if victim != keep:
                data = self._win.pop(victim)
                self._win_bytes -= len(data)
                self._ghost(self._b1, victim, len(data))
                self.stats.evictions += 1
                if self.on_event is not None:
                    self.on_event("evict", victim, len(data))
                return True
        return False

    def _evict_main_one(self) -> bool:
        """One main-region eviction per the policy (ghosting the victim)."""
        if self.policy == "arc" and self._t1 \
                and (self._t1_bytes > self._p or not self._t2):
            victim, data = self._t1.popitem(last=False)
            self._t1_bytes -= len(data)
            self._ghost(self._b1, victim, len(data))
        elif self._t2:
            victim, data = self._t2.popitem(last=False)
            self._t2_bytes -= len(data)
            if self.policy == "arc":
                self._ghost(self._b2, victim, len(data))
            # 2q: Am evictions leave no ghost (classic 2Q)
        elif self._t1:
            victim, data = self._t1.popitem(last=False)
            self._t1_bytes -= len(data)
            self._ghost(self._b1, victim, len(data))
        else:
            return False
        self.stats.evictions += 1
        if self.on_event is not None:
            self.on_event("evict", victim, len(data))
        return True

    def _shrink_main(self, cap, keep: Hashable) -> None:
        """Make room after a ghost-hit admission: main first, window last."""
        if cap is None:
            return
        while self._resident() > cap:
            if self._evict_main_one():
                continue
            if not self._evict_window(keep):
                break

    def _shrink_window(self, cap, keep: Hashable) -> None:
        """Trim the window to its share — never touching the main region
        (that is the scan-resistance invariant) and never evicting the
        block just inserted."""
        if cap is None:
            return
        win_cap = self._win_cap()
        while (self._win_bytes > win_cap or self._resident() > cap) \
                and len(self._win) > 1:
            if not self._evict_window(keep):
                break
        # degenerate budgets (window share < one block): keep the exact
        # byte budget by falling back to main-region eviction
        while self._resident() > cap:
            if not self._evict_main_one():
                break

    def _shrink_for_pin(self, cap) -> None:
        """After a pinned insert: evict unpinned blocks (window first)
        until the budget holds; pinned blocks are never victims."""
        if cap is None:
            return
        while self._resident() > cap:
            if self.policy in ("lru", "clock"):
                before = self._bytes
                self._evict_one_legacy(keep=None)
                if self._bytes == before:
                    break
            elif not (self._evict_window(None) or self._evict_main_one()):
                break

    def _trim_ghosts(self, cap) -> None:
        """Ghost lists are byte-capped by the size of the blocks they
        refer to: B1 (and 2Q's A1out) at one budget, B2 at one budget."""
        if cap is None:
            return
        while self._b1_bytes > cap and self._b1:
            _, size = self._b1.popitem(last=False)
            self._b1_bytes -= size
        while self._b2_bytes > cap and self._b2:
            _, size = self._b2.popitem(last=False)
            self._b2_bytes -= size

    def _evict_one_legacy(self, keep: Optional[Hashable]) -> None:
        if self.policy == "lru":
            for victim in self._blocks:
                if victim != keep:
                    break
            else:
                return
        else:                           # CLOCK: second chance
            victim = None
            for _pass in range(2):
                for k in list(self._blocks):
                    if k == keep:
                        continue
                    if self._ref.get(k):
                        self._ref[k] = False        # spare once
                        self._blocks.move_to_end(k)  # advance the hand
                    else:
                        victim = k
                        break
                if victim is not None:
                    break
            if victim is None:
                return
        data = self._blocks.pop(victim)
        self._bytes -= len(data)
        self._ref.pop(victim, None)
        self.stats.evictions += 1
        if self.on_event is not None:
            self.on_event("evict", victim, len(data))
