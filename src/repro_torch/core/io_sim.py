"""Block-I/O cost model.

The paper's whole point is the I/O pattern: HoD answers a query with
*sequential scans* (`O((n+m')/B)` I/O) whereas Dijkstra-style methods issue
*random* block reads.  This container has no disk-bound substrate, so we
meter I/O explicitly: every index/baseline codepath routes its "disk"
touches through a :class:`BlockDevice`, and the benchmarks report block
counts and modeled seek/scan time next to measured CPU time.

Modeled device (commodity HDD, matching the paper's 2013 setting):
sequential throughput 120 MB/s, random seek 8 ms, block size 64 KiB.
"""
from __future__ import annotations

import dataclasses

__all__ = ["BlockDevice", "IOStats"]


@dataclasses.dataclass
class IOStats:
    seq_blocks: int = 0
    rand_blocks: int = 0
    bytes_seq: int = 0
    bytes_rand: int = 0

    def modeled_seconds(self, block_bytes: int = 65536,
                        seq_mb_s: float = 120.0,
                        seek_ms: float = 8.0) -> float:
        """Modeled wall time on the reference device.

        Assumptions (commodity 2013 HDD, matching the paper's setting):

        * every access moves whole blocks — ``seq_blocks``/``rand_blocks``
          already count ``ceil(bytes / B)`` per access, so transfer time is
          ``(seq_blocks + rand_blocks) * block_bytes`` at the streaming
          rate (``seq_mb_s``); pass the same ``block_bytes`` the metering
          :class:`BlockDevice` was built with;
        * once the head is positioned, random blocks stream at the same
          rate as sequential ones — randomness costs exactly one full
          ``seek_ms`` per random block, nothing more;
        * no caching, no read-ahead, no overlap of seek and transfer.
        """
        blocks = self.seq_blocks + self.rand_blocks
        seq_t = blocks * block_bytes / (seq_mb_s * 1e6)
        seek_t = self.rand_blocks * seek_ms * 1e-3
        return seq_t + seek_t

    def __add__(self, other: "IOStats") -> "IOStats":
        return IOStats(self.seq_blocks + other.seq_blocks,
                       self.rand_blocks + other.rand_blocks,
                       self.bytes_seq + other.bytes_seq,
                       self.bytes_rand + other.bytes_rand)


class BlockDevice:
    """Accounting wrapper; all sizes in bytes, block size B (paper §2)."""

    def __init__(self, block_bytes: int = 65536):
        self.block_bytes = block_bytes
        self.stats = IOStats()
        self._cursor = -1  # last block touched, for seq/rand classification
        # Observability hook (DESIGN.md §11): called as
        # ``on_access(block_id, nbytes, sequential)`` after each
        # address-aware access.  Must be cheap and must not touch the
        # device — it fires on whichever thread charged the access.
        self.on_access = None

    def _blocks(self, nbytes: int) -> int:
        return max(1, -(-int(nbytes) // self.block_bytes))

    def sequential(self, nbytes: int) -> None:
        """A streaming read/write of nbytes (scan, append, external sort)."""
        b = self._blocks(nbytes)
        self.stats.seq_blocks += b
        self.stats.bytes_seq += int(nbytes)

    def random(self, nbytes: int) -> None:
        """A seek + read of nbytes at an arbitrary offset."""
        b = self._blocks(nbytes)
        self.stats.rand_blocks += b
        self.stats.bytes_rand += int(nbytes)

    def access_block(self, block_id: int, nbytes: int | None = None) -> None:
        """Address-aware access: consecutive block ids count as sequential."""
        nbytes = self.block_bytes if nbytes is None else nbytes
        seq = block_id == self._cursor + 1
        if seq:
            self.sequential(nbytes)
        else:
            self.random(nbytes)
        self._cursor = block_id
        if self.on_access is not None:
            self.on_access(block_id, nbytes, seq)

    def external_sort(self, nbytes: int, mem_bytes: int) -> None:
        """Charge a standard multi-way merge sort: 2 passes if it fits a
        single merge fan-in, else 2·ceil(log_k(N/M)) passes."""
        import math

        if nbytes <= mem_bytes:
            self.sequential(nbytes)  # read once, sort in memory, write once
            self.sequential(nbytes)
            return
        runs = -(-nbytes // mem_bytes)
        fan_in = max(2, mem_bytes // self.block_bytes - 1)
        passes = 1 + max(1, math.ceil(math.log(max(runs, 2), fan_in)))
        self.sequential(2 * passes * nbytes)

    def reset(self) -> IOStats:
        out, self.stats = self.stats, IOStats()
        self._cursor = -1
        return out
