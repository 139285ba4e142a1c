"""Block-range partitioning of a store's segments across N shards
(DESIGN.md §13); a copy of the JAX package's ``fleet/partition.py``.

The unit of placement is the **logical data block** — the same unit
the page cache budgets and the modeled device meters — so a shard's
byte accounting is exactly the single-host accounting restricted to
the blocks it owns.  Each swept segment (``plan_f``, ``plan_b``) is
split into N *contiguous* block ranges balanced by block count:

* a level sweep visits blocks in ascending order, so a contiguous
  range keeps each shard's device scan modeled-sequential (at most
  N - 1 range crossings per full-segment scan, vs one random seek per
  block under round-robin);
* the owner of a global block is a closed-form ``(b - 1) * N // B``
  (no lookup tables), and the shard-local block id is a simple offset
  so local ids are dense and 1-based exactly like a single-host store.

The pinned ``plan_core`` tier is *replicated*: on a real fleet every
host pins its own copy so core sweeps never cross the network.  The
single-machine emulation materializes the one copy every answer is
computed from on shard 0 and documents the replication factor instead
of multiplying the byte counters — that keeps fleet-aggregate
``bytes_read`` directly comparable to the single-host baseline (the
``N>1 must not read more than N=1`` gate).

``owner_fn`` injects a custom placement (tests use it to force
degenerate layouts: every block on one shard, a shard that owns
nothing).  Injected placements fall back to single-host block
numbering since contiguity is no longer guaranteed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from ..storage.blockfile import SEGMENT_NAMES, _SEGMENT_ID_STRIDE

__all__ = ["StorePartition", "REPLICATED_SEGMENTS"]

#: segments replicated to every shard rather than range-partitioned
#: (the pinned tier; see module docstring for the emulation story).
REPLICATED_SEGMENTS: Tuple[str, ...] = ("plan_core",)


class StorePartition:
    """Immutable block → shard map for one store's segments.

    ``seg_blocks`` maps segment name → logical data-block count (from
    :meth:`repro_torch.storage.blockfile.IndexStore.segment_blocks`).
    """

    def __init__(self, seg_blocks: Dict[str, int], n_shards: int,
                 replicated: Sequence[str] = REPLICATED_SEGMENTS,
                 owner_fn: Optional[Callable[[str, int], int]] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        unknown = set(seg_blocks) - set(SEGMENT_NAMES)
        if unknown:
            raise ValueError(f"unknown segments: {sorted(unknown)}")
        self.n_shards = int(n_shards)
        self.seg_blocks = dict(seg_blocks)
        self.replicated = frozenset(replicated)
        self._owner_fn = owner_fn
        self._seg_index = {n: i for i, n in enumerate(SEGMENT_NAMES)}

    # ------------------------------------------------------------- placement
    def owner(self, name: str, block: int) -> int:
        """Shard that owns global data block ``block`` (1-based) of
        segment ``name``."""
        n_blocks = self.seg_blocks[name]
        if not 1 <= block <= n_blocks:
            raise ValueError(f"{name}: block {block} out of range "
                             f"(1..{n_blocks})")
        if name in self.replicated:
            return 0            # emulation: the one materialized copy
        if self._owner_fn is not None:
            return self._owner_fn(name, block)
        return (block - 1) * self.n_shards // n_blocks

    def range_start(self, name: str, shard: int) -> int:
        """First global block of ``shard``'s contiguous range (the
        range may be empty when N exceeds the block count).  The ceil
        form is the exact inverse of :meth:`owner`'s
        ``(b - 1) * N // B``: block ``b`` belongs to shard ``s`` iff
        ``ceil(s * B / N) < b <= ceil((s + 1) * B / N)``."""
        return -(-shard * self.seg_blocks[name] // self.n_shards) + 1

    def local_block(self, name: str, block: int) -> int:
        """Shard-local block id: dense, 1-based within the owner's
        range, offset into the owning segment's id space — the same
        ``base + local`` numbering a single-host store uses, so the
        per-shard device's sequential/random classification behaves
        identically."""
        base = self._seg_index[name] * _SEGMENT_ID_STRIDE
        if name in self.replicated or self._owner_fn is not None:
            return base + block     # single-host numbering fallback
        start = self.range_start(name, self.owner(name, block))
        return base + (block - start) + 1

    # ------------------------------------------------------------ accounting
    def shard_blocks(self, shard: int) -> int:
        """Blocks owned by ``shard`` (replicated segments count toward
        their materialized home, shard 0)."""
        total = 0
        for name, n_blocks in self.seg_blocks.items():
            if name in self.replicated or self._owner_fn is not None:
                total += sum(1 for b in range(1, n_blocks + 1)
                             if self.owner(name, b) == shard)
            else:
                total += (self.range_start(name, shard + 1)
                          - self.range_start(name, shard))
        return total

    def describe(self) -> str:
        parts = []
        for name in SEGMENT_NAMES:
            if name not in self.seg_blocks:
                continue
            if name in self.replicated:
                parts.append(f"{name}: replicated "
                             f"({self.seg_blocks[name]} blocks)")
            else:
                ranges = [
                    f"[{self.range_start(name, s)}.."
                    f"{self.range_start(name, s + 1) - 1}]"
                    for s in range(self.n_shards)]
                parts.append(f"{name}: {' '.join(ranges)}")
        return "; ".join(parts)
