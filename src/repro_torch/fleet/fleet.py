"""Sharded serving fleet over one block-segment store (DESIGN.md §13).

A copy of the JAX package's ``fleet/fleet.py``: host code, numpy and
threads, against this package's own store, cache and device.

A :class:`ServingFleet` opens an
:class:`~repro_torch.storage.blockfile.IndexStore` whose ``cache`` and
``device`` are *routing façades*: every page-cache transaction and every
modeled device charge is forwarded to the shard that owns the block,
where a real per-shard :class:`~repro_torch.storage.pagecache.PageCache`
(its slice of the fleet-wide byte budget) and
:class:`~repro_torch.core.io_sim.BlockDevice` (its own spindle, its own
sequential/random cursor) do the work.  The compute plane —
:class:`~repro_torch.storage.stream.StreamingQueryEngine`, its one
``edge_relax`` launch a streamed level and its ``tropical_matmul`` core
search on the card, the fixed batch shapes — is the single-host code:
shards partition *storage*, not *math*, which makes bit-identical
answers at every N a structural property rather than a numerical
accident.

Thread-backed shard workers: each shard owns a 1-wide io executor
(ordered preads against its local block ranges) and a decode pool.
The read pipeline (``storage/pipeline.py``) splits a level's
missed-block runs at ownership boundaries and dispatches each run to
its owner's pools, so shards read and decode concurrently — N spindles
in parallel — and a shard-local fault (CRC mismatch, short read)
travels the same discard/fail path back into the query thread as on a
single host.

Budget split: shard ``s`` gets ``ceil(B * owned_s / sum(owned))``
rounded **up** to a whole ``block_bytes`` multiple, where ``owned_s``
is the shard's block footprint *including* the replicated pinned tier
on its materialized home (shard 0).  Footprint-proportional is the
static split that best mirrors how a single global cache distributes
its capacity across the same blocks: an equal ``B / N`` split starves
whichever shard owns the most blocks (shard 0 squeezed by the
materialized ``plan_core`` copy at N=4, or the non-core shard starved
at N=2), each inflating fleet reads past one host's.  Rounding up
(never down) means every shard holds at least its proportional share
of whole blocks, so the fleet may hold up to ``N * block_bytes`` more
than ``B`` resident in the worst case — bounded, and metered
(``FleetStats`` reports the exact per-shard budgets).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from ..core.io_sim import BlockDevice, IOStats
from ..storage.blockfile import (IndexStore, PIN_SEGMENTS, SEGMENT_NAMES,
                                 _SEGMENT_ID_STRIDE)
from ..storage.pagecache import CacheStats, PageCache
from .partition import StorePartition

__all__ = ["FleetCache", "FleetDevice", "FleetShard", "FleetStats",
           "ServingFleet", "split_budget"]


def split_budget(total: Optional[int], n_shards: int,
                 block_bytes: int,
                 owned_blocks: Optional[Sequence[int]] = None,
                 floors: Optional[Sequence[int]] = None
                 ) -> List[Optional[int]]:
    """Per-shard cache budgets (module docstring): the fleet budget
    splits *proportional to each shard's owned block footprint* —
    which is how a global cache's capacity ends up distributed across
    the same blocks on a single host, and automatically funds shard
    0's materialized copy of the replicated pinned tier — then rounds
    each share **up** to a whole block.  ``floors[s]`` raises shard
    ``s``'s slice to at least that many bytes (the replicated tier's
    home shard is floored at the tier's footprint: every query sweeps
    the whole tier, so anything smaller guarantees a thrash loop).
    ``None`` (unbounded) splits to all-``None``; a degenerate 1-shard
    fleet keeps the exact budget so it is counter-for-counter
    identical to an unsharded server."""
    if total is None:
        return [None] * n_shards
    if n_shards == 1:
        return [int(total)]
    owned = ([1] * n_shards if owned_blocks is None
             else [max(0, int(b)) for b in owned_blocks])
    weight = sum(owned) or n_shards
    out = []
    for s in range(n_shards):
        share = -(-int(total) * (owned[s] or 1) // weight)
        if floors is not None:
            share = max(share, int(floors[s]))
        rem = share % block_bytes
        out.append(share + (block_bytes - rem) if rem else share)
    return out


class FleetCache:
    """Routing façade with the :class:`PageCache` interface: every
    call forwards to the shard cache that owns the key's block.  Built
    unconfigured so the store can open against it; :meth:`configure`
    wires the partition + shard caches from store geometry."""

    def __init__(self):
        self._part: Optional[StorePartition] = None
        self._caches: List[PageCache] = []
        self._ns_names: Dict[str, str] = {}
        self._on_event = None

    def configure(self, partition: StorePartition,
                  ns_names: Dict[str, str],
                  caches: Sequence[PageCache]) -> None:
        self._part = partition
        self._ns_names = dict(ns_names)
        self._caches = list(caches)

    def owner_of(self, key) -> int:
        ns, block = key
        return self._part.owner(self._ns_names[ns], block)

    def _route(self, key) -> PageCache:
        return self._caches[self.owner_of(key)]

    # ------------------------------------------------- PageCache interface
    def get(self, key, load, pin: bool = False):
        return self._route(key).get(key, load, pin=pin)

    def begin_fill(self, key, size: int, disk_bytes: Optional[int] = None,
                   pin: bool = False, charge=None):
        return self._route(key).begin_fill(key, size, disk_bytes,
                                           pin=pin, charge=charge)

    def discard(self, key, entry) -> None:
        self._route(key).discard(key, entry)

    def unpin(self, keys) -> None:
        by_owner: Dict[int, list] = {}
        for k in keys:
            by_owner.setdefault(self.owner_of(k), []).append(k)
        for owner, ks in by_owner.items():
            self._caches[owner].unpin(ks)

    def clear(self) -> None:
        for c in self._caches:
            c.clear()

    def reset_stats(self, also=()) -> CacheStats:
        """Compound reset: shards 1..N-1 and the caller's ``also``
        callbacks all run inside shard 0's stats lock, preserving the
        no-half-charged-fill atomicity the single-host reset gives
        (shard locks nest in index order, so this cannot deadlock).
        Returns the summed pre-reset stats."""
        olds: List[CacheStats] = []

        def chain():
            for c in self._caches[1:]:
                olds.append(c.reset_stats())
            for cb in also:
                cb()

        old0 = self._caches[0].reset_stats(also=[chain])
        total = old0
        for o in olds:
            total = total + o
        return total

    # ------------------------------------------------------------- metrics
    @property
    def stats(self) -> CacheStats:
        total = CacheStats()
        for c in self._caches:
            total = total + c.stats
        return total

    @property
    def on_event(self):
        return self._on_event

    @on_event.setter
    def on_event(self, hook) -> None:
        self._on_event = hook
        for c in self._caches:
            c.on_event = hook

    @property
    def pin_frac(self):
        return self._caches[0].pin_frac if self._caches else None

    @property
    def resident_bytes(self) -> int:
        return sum(c.resident_bytes for c in self._caches)

    @property
    def pinned_bytes(self) -> int:
        return sum(c.pinned_bytes for c in self._caches)

    def pinned_keys(self):
        out = set()
        for c in self._caches:
            out |= set(c.pinned_keys())
        return out

    def resident_keys(self):
        out = set()
        for c in self._caches:
            out |= set(c.resident_keys())
        return out


class FleetDevice:
    """Routing façade with the :class:`BlockDevice` interface: a
    global block id (``segment_base + block``) decomposes back to
    ``(segment, block)``, routes to the owning shard's device under
    the shard-*local* dense block id — so each shard's
    sequential/random classification sees exactly the scan a host
    holding that range would see."""

    def __init__(self):
        self._part: Optional[StorePartition] = None
        self._ns_names: Dict[str, str] = {}
        self.shard_devices: List[BlockDevice] = []
        self.block_bytes: Optional[int] = None
        self._on_access = None

    def configure(self, partition: StorePartition,
                  devices: Sequence[BlockDevice],
                  block_bytes: int) -> None:
        self._part = partition
        self.shard_devices = list(devices)
        self.block_bytes = int(block_bytes)

    # ----------------------------------------------- BlockDevice interface
    def access_block(self, block_id: int, nbytes: Optional[int] = None
                     ) -> None:
        seg_idx, block = divmod(block_id, _SEGMENT_ID_STRIDE)
        name = SEGMENT_NAMES[seg_idx]
        shard = self._part.owner(name, block)
        local = self._part.local_block(name, block)
        self.shard_devices[shard].access_block(local, nbytes)

    def sequential(self, nbytes: int) -> None:
        self.shard_devices[0].sequential(nbytes)

    def random(self, nbytes: int) -> None:
        self.shard_devices[0].random(nbytes)

    def reset(self) -> IOStats:
        old = self.stats
        for d in self.shard_devices:
            d.reset()
        return old

    # ------------------------------------------------------------- metrics
    @property
    def stats(self) -> IOStats:
        total = IOStats()
        for d in self.shard_devices:
            total = total + d.stats
        return total

    @property
    def on_access(self):
        return self._on_access

    @on_access.setter
    def on_access(self, hook) -> None:
        self._on_access = hook
        for d in self.shard_devices:
            d.on_access = hook


@dataclasses.dataclass
class FleetShard:
    """One serving shard: its cache slice, its modeled spindle, and
    its worker pools (1-wide ordered io + a decode pool)."""
    index: int
    cache: PageCache
    device: BlockDevice
    io: ThreadPoolExecutor
    decode: ThreadPoolExecutor
    budget_bytes: Optional[int]

    def shutdown(self) -> None:
        self.io.shutdown(wait=True)
        self.decode.shutdown(wait=True)


@dataclasses.dataclass
class FleetStats:
    """Point-in-time fleet aggregate: per-shard rows plus the summed
    cache/io stats ``ServerStats.report`` and the smokes' ``fleet``
    table consume."""
    rows: List[dict]
    cache: CacheStats
    io: IOStats

    def report_lines(self) -> List[str]:
        lines = []
        for r in self.rows:
            budget = (f"{r['budget_bytes'] / 1e6:.1f} MB"
                      if r["budget_bytes"] is not None else "unbounded")
            lines.append(
                f"  shard {r['shard']}: {r['blocks']} blocks, "
                f"budget {budget}, hit rate {r['hit_rate']:.3f} "
                f"({r['hits']}/{r['hits'] + r['misses']}), "
                f"{r['bytes_read'] / 1e6:.1f} MB read, "
                f"io {r['io_model_s'] * 1e3:.2f} ms modeled")
        return lines


class ServingFleet:
    """Open a store sharded N ways on one machine (module docstring).

    The returned fleet owns ``fleet.store`` — an :class:`IndexStore`
    whose cache/device are the routing façades — plus the N
    :class:`FleetShard` workers.  Pass ``fleet.store`` to a
    :class:`StreamingQueryEngine` exactly like a plain store; closing
    the store shuts the shard workers down.

    ``owner_fn`` overrides block placement (tests force degenerate
    layouts with it); ``cache_bytes`` is the *fleet-wide* budget,
    split per shard by :func:`split_budget`.
    """

    def __init__(self, store_path: str, n_shards: int, *,
                 cache_bytes: Optional[int] = None,
                 cache_policy: str = "2q",
                 pin_frac: Optional[float] = None,
                 decode_workers: int = 2,
                 owner_fn: Optional[Callable[[str, int], int]] = None,
                 pin_segments: Optional[Sequence[str]] = PIN_SEGMENTS):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.budget_bytes = cache_bytes
        self.cache = FleetCache()
        self.device = FleetDevice()
        self.shards: List[FleetShard] = []
        self._workers_down = False
        store = IndexStore(store_path, device=self.device,
                           cache=self.cache, pin_segments=pin_segments)
        try:
            seg_blocks = store.segment_blocks()
            self.partition = StorePartition(seg_blocks, self.n_shards,
                                            owner_fn=owner_fn)
            owned = [self.partition.shard_blocks(i)
                     for i in range(self.n_shards)]
            repl_bytes = sum(
                seg_blocks[name] * store.block_bytes
                for name in self.partition.replicated
                if name in seg_blocks) if owner_fn is None else 0
            floors = [repl_bytes] + [0] * (self.n_shards - 1)
            budgets = split_budget(cache_bytes, self.n_shards,
                                   store.block_bytes,
                                   owned_blocks=owned, floors=floors)
            self.shard_budget_bytes = budgets
            for i in range(self.n_shards):
                self.shards.append(FleetShard(
                    index=i,
                    cache=PageCache(budgets[i], policy=cache_policy,
                                    pin_frac=pin_frac),
                    device=BlockDevice(block_bytes=store.block_bytes),
                    io=ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix=f"hod-shard{i}-io"),
                    decode=ThreadPoolExecutor(
                        max_workers=decode_workers,
                        thread_name_prefix=f"hod-shard{i}-decode"),
                    budget_bytes=budgets[i]))
            ns_names = {seg._cache_ns: name
                        for name, seg in store.segments.items()}
            self.cache.configure(self.partition, ns_names,
                                 [s.cache for s in self.shards])
            self.device.configure(self.partition,
                                  [s.device for s in self.shards],
                                  store.block_bytes)
            store.fleet = self
            self.store = store
        except Exception:
            self.shutdown_workers()
            store.close()
            raise

    # --------------------------------------------------------------- routing
    def owner_of_key(self, key) -> int:
        """Shard owning a page-cache key — the read pipeline's
        run-splitting hook."""
        return self.cache.owner_of(key)

    # ------------------------------------------------------------ accounting
    def stats(self) -> FleetStats:
        rows = []
        for s in self.shards:
            cs = s.cache.stats
            io = s.device.stats
            rows.append({
                "shard": s.index,
                "blocks": self.partition.shard_blocks(s.index),
                "budget_bytes": s.budget_bytes,
                "hits": cs.hits,
                "misses": cs.misses,
                "hit_rate": cs.hit_rate(),
                "bytes_read": cs.bytes_read,
                "bytes_filled": cs.bytes_filled,
                "io_model_s": io.modeled_seconds(
                    block_bytes=self.store.block_bytes),
            })
        return FleetStats(rows=rows, cache=self.cache.stats,
                          io=self.device.stats)

    # ------------------------------------------------------------- lifecycle
    def shutdown_workers(self) -> None:
        """Idempotent; invoked by ``IndexStore.close()`` via the
        ``store.fleet`` back-reference."""
        if self._workers_down:
            return
        self._workers_down = True
        for s in self.shards:
            s.shutdown()
