"""Disk-resident HoD index store: block segment files (DESIGN.md §6).

A copy of the JAX package's ``storage/blockfile.py`` against this
package's own ``core/index.py`` and ``core/io_sim.py``: it writes
segment files byte-identical to the JAX package's and reads theirs.

A *store* is a directory holding the index in two tiers:

* ``resident.npz`` — the small, always-in-memory tier: permutations,
  level pointers, core closure/CSR, and the legacy chunk arrays.  This
  is exactly the v1 ``.npz`` content (plus store metadata), so the
  memory a store-backed engine must hold is independent of the sweep
  plans' padded envelope;
* ``plan_f.seg`` / ``plan_b.seg`` / ``plan_core.seg`` — one *segment
  file* per :class:`~repro_torch.core.index.SweepPlan`, the tier queries
  stream.  A v5 segment is a fixed-size *logical* block space stored
  as variable-length compressed frames::

      block 0        header: magic, format version (5), block_bytes,
                     n_real/l_pad/m_pad/k_fix/sentinel, footer extent
      frames 1..     one frame per logical data block, back-to-back:
                     (codec_id u8, comp_len u32, crc32 u32) + payload
                     compressed by the per-block codec
                     (`storage/codecs.py`: raw / delta / f16)
      footer         JSON per-level extent table [byte_off, byte_len,
                     m_real] (logical offsets) + per-frame table
                     [file_off, comp_len, codec_id, crc] + codec name

  The *logical* stream the extents address is exactly the v4 affinity
  layout: compact level slabs back-to-back at byte granularity, padded
  levels/rows reconstructed from header defaults.  Level addressing,
  cache keys, and the sweep's block-id order are therefore codec-
  independent — only the bytes on disk shrink.  Each frame decodes
  alone (the codec span maps are derived from the extents), so random
  block access never touches a neighbor; a frame that a codec cannot
  shrink is stored raw (``codec_id`` is per frame).

  The v4 *affinity layout* (build-time partitioning, ROADMAP): a level
  slab stores only the level's **real** rows —
  ``dst[int32 m] · src_idx[int32 m·K] · w[f32 m·K] · assoc[int32 m·K]``
  with ``m = m_real ≤ M_pad`` — and consecutive slabs are packed into
  the same block neighborhood instead of each being block-aligned.
  Two effects on a partial cache: the per-sweep block working set
  shrinks by the padding-row envelope (often 2-3x on level-skewed
  graphs), and adjacent levels *share* their boundary block, so every
  level hand-off re-references a just-read block — hits that exist at
  any budget.  Padding rows and padding levels are reconstructed from
  header defaults, bit-exactly.  A full sweep is still one sequential
  scan per segment (the paper's §4.5 invariant): blocks are read in
  ascending id order.  v3 segments (block-aligned full-``M_pad``
  slabs) keep loading.

Every block read goes through a :class:`~repro_torch.storage
.pagecache.PageCache` and — on a miss — is metered through the store's
:class:`~repro_torch.core.io_sim.BlockDevice` with a *global* block id
(segments get disjoint id ranges), so ``IOStats`` classifies the
actual read pattern.  Codec frames *decompress on cache fill*: the
cache holds (and budgets) the decompressed ``block_bytes`` payload,
while the device and ``CacheStats.bytes_read`` are charged the
*compressed* payload bytes the miss actually read — frame and footer
metadata, like the v4 footer, are uncharged.  Misses are integrity-
checked against the frame CRC32 (v4: the footer's per-block CRCs), so
a corrupt segment surfaces as a ``ValueError`` in the querying thread
instead of silent garbage distances.  Open-time header/footer reads
are not charged; only query-time block fetches are.

Segment-aware admission (DESIGN.md §6): ``IndexStore`` marks the
small, repeatedly-re-read segments (``plan_core`` by default) as
*pinned* — their blocks are pinned into the page cache on first read
(within the cache's pin budget), so a once-per-sweep ``plan_f`` scan
can never evict them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.index import (FORMAT_VERSION, HoDIndex, SweepPlan,
                          _empty_plan, core_scan_bytes, scan_cost_bytes)
from ..core.io_sim import BlockDevice
from .codecs import (CODEC_IDS, block_spans, decode_block, encode_block,
                     level_spans)
from .pagecache import PageCache

__all__ = ["IndexStore", "SegmentReader", "save_store", "open_store",
           "load_store", "segment_bytes", "segment_logical_bytes",
           "SEGMENT_NAMES", "DEFAULT_BLOCK_BYTES", "DEFAULT_CODEC",
           "PIN_SEGMENTS"]

MAGIC = b"HODSEG05"
_MAGIC_V4 = b"HODSEG04"
_MAGIC_V3 = b"HODSEG03"
_HEADER = struct.Struct("<8sIIIIIIIIQQ")   # magic, version, block_bytes,
# n_real, l_pad, m_pad, k_fix, sentinel, reserved, footer_off, footer_len
#: v5 per-frame header: codec_id (u8), pad, comp_len (u32), crc32 (u32).
_FRAME = struct.Struct("<B3xII")
RESIDENT_FILE = "resident.npz"
SEGMENT_NAMES = ("plan_f", "plan_b", "plan_core")
#: codec a store is written with unless asked otherwise — ``raw`` keeps
#: fills decode-free (the v4-equivalent payload, framed); ``delta``
#: trades decode CPU for compressed reads (`storage/codecs.py`).
DEFAULT_CODEC = "raw"
#: segments pinned resident by default (segment-aware admission): the
#: core plan is small, read once per SSSP reconstruction, and exactly
#: the kind of hot tier a cyclic ``plan_f`` scan would otherwise evict.
PIN_SEGMENTS = ("plan_core",)
#: paper §2 block size (64 KiB) — the modeled device's unit.
DEFAULT_BLOCK_BYTES = 65536
#: disjoint global-block-id ranges per segment, so the device's
#: seq/random cursor sees a cross-segment switch as one seek.
_SEGMENT_ID_STRIDE = 1 << 40

INF = np.float32(np.inf)


def _trim_rows(plan: SweepPlan, lvl: int, sentinel: int) -> int:
    """Number of leading real rows of a level slab, or ``-1`` when the
    level is not a clean real-prefix + default-padding split (never the
    case for ``pack_index`` plans; kept as a lossless fallback)."""
    valid = plan.row_valid[lvl]
    m_real = int(valid.sum())
    if not (valid[:m_real].all() and not valid[m_real:].any()):
        return -1
    if not ((plan.dst[lvl, m_real:] == sentinel).all()
            and (plan.src_idx[lvl, m_real:] == sentinel).all()
            and np.isinf(plan.w[lvl, m_real:]).all()
            and (plan.assoc[lvl, m_real:] == -1).all()):
        return -1
    return m_real


# --------------------------------------------------------------------- write
def _level_slab(plan: SweepPlan, lvl: int, m_real: int) -> bytes:
    """Serialize one level: compact (real rows only) when ``m_real >= 0``,
    else the full rectangle with an explicit valid vector."""
    if m_real >= 0:
        sl = slice(0, m_real)
        parts = (np.ascontiguousarray(plan.dst[lvl, sl], np.int32),
                 np.ascontiguousarray(plan.src_idx[lvl, sl], np.int32),
                 np.ascontiguousarray(plan.w[lvl, sl], np.float32),
                 np.ascontiguousarray(plan.assoc[lvl, sl], np.int32))
    else:
        parts = (np.ascontiguousarray(plan.dst[lvl], np.int32),
                 np.ascontiguousarray(plan.row_valid[lvl], np.uint8),
                 np.ascontiguousarray(plan.src_idx[lvl], np.int32),
                 np.ascontiguousarray(plan.w[lvl], np.float32),
                 np.ascontiguousarray(plan.assoc[lvl], np.int32))
    return b"".join(p.tobytes() for p in parts)


def _segment_spans(extents, k_fix: int):
    """Typed span map of a segment's whole logical stream (shared by
    the writer and the v5 reader — both derive it from the extents)."""
    spans = []
    for off, length, m_real in extents:
        spans.extend(level_spans(off, length, m_real, k_fix))
    return spans


def _write_segment(path: str, plan: SweepPlan, sentinel: int,
                   block_bytes: int, codec: str = DEFAULT_CODEC) -> None:
    if block_bytes < _HEADER.size:
        raise ValueError(f"block_bytes must be >= {_HEADER.size}")
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown codec {codec!r} "
                         f"(have {sorted(CODEC_IDS)})")
    n_real = plan.n_real_levels
    extents = []
    slabs = []
    off = block_bytes                     # logical data starts at block 1
    for lvl in range(n_real):
        m_real = _trim_rows(plan, lvl, sentinel)
        slab = _level_slab(plan, lvl, m_real)
        extents.append([off, len(slab), m_real])
        slabs.append(slab)
        off += len(slab)
    data = b"".join(slabs)
    pad = (-len(data)) % block_bytes
    data += b"\0" * pad
    n_data_blocks = len(data) // block_bytes
    spans = _segment_spans(extents, plan.k_fix)
    span_starts = [s for _, s, _ in spans]
    frames = []                           # [file_off, comp_len, id, crc]
    frame_blobs = []
    file_off = block_bytes                # frames start after the header
    for i in range(n_data_blocks):
        lo = (i + 1) * block_bytes        # logical window of block i+1
        payload = data[i * block_bytes:(i + 1) * block_bytes]
        codec_id, blob = encode_block(
            codec, payload,
            block_spans(spans, lo, lo + block_bytes, starts=span_starts))
        crc = zlib.crc32(blob)
        frames.append([file_off, len(blob), codec_id, crc])
        frame_blobs.append(_FRAME.pack(codec_id, len(blob), crc) + blob)
        file_off += _FRAME.size + len(blob)
    footer = json.dumps({"extents": extents, "n_real": n_real,
                         "codec": codec, "frames": frames}).encode()
    header = _HEADER.pack(MAGIC, FORMAT_VERSION, block_bytes, n_real,
                          plan.l_pad, plan.m_pad, plan.k_fix, sentinel, 0,
                          file_off, len(footer))
    with open(path, "wb") as f:
        f.write(header.ljust(block_bytes, b"\0"))
        for blob in frame_blobs:
            f.write(blob)
        f.write(footer)


def save_store(ix: HoDIndex, path: str,
               block_bytes: int = DEFAULT_BLOCK_BYTES,
               codec: str = DEFAULT_CODEC) -> None:
    """Write ``ix`` as a disk-resident store directory at ``path``.

    The resident tier reuses the ``.npz`` machinery (minus the plan
    arrays); each sweep plan becomes one v5 block segment file — the
    v4 affinity logical layout (compact level slabs sharing block
    neighborhoods), framed per block by ``codec`` (``"raw"`` /
    ``"delta"`` / ``"f16"``, see `storage/codecs.py`).  Per-plan
    compact-payload counts (real rows/edges) ride in the resident file
    so a store-backed server can model the paper-comparable scan cost
    without materializing any plan.
    """
    ix.ensure_plans()
    os.makedirs(path, exist_ok=True)
    plan_stats = {}
    for name in SEGMENT_NAMES:
        p: SweepPlan = getattr(ix, name)
        plan_stats[f"{name}_rows"] = np.int64(p.row_valid.sum())
        plan_stats[f"{name}_edges"] = np.int64(np.isfinite(p.w).sum())
    np.savez_compressed(
        os.path.join(path, RESIDENT_FILE), meta=ix._meta_array(),
        format_version=np.int64(FORMAT_VERSION),
        store=np.bool_(True), block_bytes=np.int64(block_bytes),
        codec=np.str_(codec), k_cap=np.int64(ix.k_cap),
        **ix.resident_arrays(), **plan_stats)
    for name in SEGMENT_NAMES:
        _write_segment(os.path.join(path, f"{name}.seg"),
                       getattr(ix, name), ix.n, block_bytes, codec=codec)


# ---------------------------------------------------------------------- read
class SegmentReader:
    """One open segment file: header/footer-described slab geometry +
    cached, CRC-checked, device-metered block reads (thread-safe via
    ``os.pread``).  Reads v5 codec-framed segments plus the v4
    affinity layout and v3 block-aligned segments."""

    def __init__(self, path: str, base_block: int, device: BlockDevice,
                 cache: PageCache, name: str, pin_blocks: bool = False):
        self.path, self.name = path, name
        self.device, self.cache = device, cache
        self.base_block = base_block
        #: pin this segment's blocks into the cache on read (segment-
        #: aware admission; subject to the cache's pin budget).
        self.pin_blocks = bool(pin_blocks)
        # Cache keys are namespaced by the segment's absolute path: a
        # PageCache shared between stores (one global memory budget)
        # must never serve one store's blocks to another.
        self._cache_ns = os.path.abspath(path)
        self._fd = os.open(path, os.O_RDONLY)
        try:
            raw = os.pread(self._fd, _HEADER.size, 0)
            (magic, self.version, self.block_bytes, self.n_real,
             self.l_pad, self.m_pad, self.k_fix, self.sentinel, _res,
             footer_off, footer_len) = _HEADER.unpack(raw)
            if magic not in (MAGIC, _MAGIC_V4, _MAGIC_V3):
                raise ValueError(f"{path}: not a HoD segment file "
                                 f"(magic {magic!r})")
            if self.version > FORMAT_VERSION:
                raise ValueError(f"{path}: segment format "
                                 f"v{self.version} is newer than this "
                                 f"reader (v{FORMAT_VERSION})")
            footer = json.loads(os.pread(self._fd, footer_len, footer_off))
            if footer["n_real"] != self.n_real:
                raise ValueError(
                    f"{path}: footer/header level count mismatch")
            self.extents = footer["extents"]
            self._crcs = footer.get("crcs")   # v4 only (absent in v3)
            #: v5: [file_off, comp_len, codec_id, crc] per data block,
            #: plus the codec the segment was written with
            self._frames = footer.get("frames")
            self.codec = footer.get("codec", "raw")
            self._spans = (_segment_spans(self.extents, self.k_fix)
                           if self.version >= 5 else None)
            #: bisect index into the (sorted) span map, so a cache miss
            #: clips one block's window in O(log L) not O(L)
            self._span_starts = ([s for _, s, _ in self._spans]
                                 if self._spans is not None else None)
        except Exception:
            self.close()
            raise

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    # ------------------------------------------------------------- block I/O
    def frame_info(self, block: int) -> Tuple[int, int]:
        """``(decoded_bytes, disk_bytes)`` of one logical block — known
        from footer metadata alone, *before* any read happens.  This is
        what lets the read pipeline admit a block's budget and charge
        ``bytes_read`` at submit time (`storage/pipeline.py`)."""
        if self.version >= 5:
            return self.block_bytes, self._frames[block - 1][1]
        return self.block_bytes, self.block_bytes

    def read_frames(self, b0: int, b1: int) -> bytes:
        """Raw on-disk bytes of blocks ``b0..b1`` inclusive in **one**
        pread (batched extent read).  v5 frames are written
        back-to-back, so any contiguous block run is one file range;
        v3/v4 blocks are block-aligned.  Slice per block with
        :meth:`frame_slice`; no device charge happens here."""
        if self.version >= 5:
            off0 = self._frames[b0 - 1][0]
            off1, comp_len = self._frames[b1 - 1][:2]
            return os.pread(self._fd, off1 + _FRAME.size + comp_len - off0,
                            off0)
        return os.pread(self._fd, (b1 - b0 + 1) * self.block_bytes,
                        b0 * self.block_bytes)

    def frame_slice(self, buf: bytes, b0: int, block: int) -> bytes:
        """One block's frame bytes out of a ``read_frames(b0, ...)``
        buffer."""
        if self.version >= 5:
            off = self._frames[block - 1][0] - self._frames[b0 - 1][0]
            return buf[off:off + _FRAME.size + self._frames[block - 1][1]]
        off = (block - b0) * self.block_bytes
        return buf[off:off + self.block_bytes]

    def decode_frame(self, block: int, raw: bytes) -> bytes:
        """CRC-verify + decode one block's frame bytes into the decoded
        ``block_bytes`` payload.  Pure CPU — this is the part the read
        pipeline runs on its decode worker pool; a corrupt frame raises
        the same ``ValueError`` the synchronous path does."""
        if self.version >= 5:
            _file_off, comp_len, codec_id, crc = self._frames[block - 1]
            f_codec, f_len, f_crc = _FRAME.unpack_from(raw)
            blob = raw[_FRAME.size:]
            if (len(blob) != comp_len or f_codec != codec_id
                    or f_len != comp_len or f_crc != crc
                    or zlib.crc32(blob) != crc):
                raise ValueError(
                    f"{self.path}: CRC mismatch in block {block} — "
                    "corrupt segment read")
            lo = block * self.block_bytes
            return decode_block(
                codec_id, blob,
                block_spans(self._spans, lo, lo + self.block_bytes,
                            starts=self._span_starts),
                self.block_bytes)
        if self._crcs is not None and 1 <= block <= len(self._crcs):
            if zlib.crc32(raw) != self._crcs[block - 1]:
                raise ValueError(
                    f"{self.path}: CRC mismatch in block {block} — "
                    "corrupt segment read")
        return raw

    def _load_block(self, block: int):
        """Load one logical block for the page cache.

        v5 returns ``(decompressed_payload, compressed_bytes)`` — the
        decompress-on-fill pair the cache budgets/meters respectively;
        v3/v4 return the raw block (read bytes == resident bytes).  The
        device is charged the bytes actually read off "disk" (the
        compressed frame payload; frame/footer metadata is uncharged).
        """
        raw = self.read_frames(block, block)
        data = self.decode_frame(block, raw)
        if self.version >= 5:
            comp_len = self._frames[block - 1][1]
            self.device.access_block(self.base_block + block, comp_len)
            return data, comp_len
        self.device.access_block(self.base_block + block, len(data))
        return data

    def data_blocks(self) -> int:
        """Number of logical data blocks (1..n) in this segment — the
        unit the fleet partitioner splits across shards
        (``fleet/partition.py``)."""
        if self._frames is not None:        # v5: one frame per block
            return len(self._frames)
        last = 0
        for lvl in range(self.n_real):
            last = max(last, self._level_blocks(lvl)[1])
        return last

    def _level_blocks(self, lvl: int) -> Tuple[int, int, int]:
        """(first_block, last_block, offset_of_first_byte_in_first_block)
        of one level's slab."""
        if self.version >= 4:
            off, length, _ = self.extents[lvl]
            b0 = off // self.block_bytes
            b1 = (off + max(length, 1) - 1) // self.block_bytes
            return b0, b1, off - b0 * self.block_bytes
        start, n_blocks, _ = self.extents[lvl]
        return start, start + n_blocks - 1, 0

    def level_keys(self, lvl: int):
        """The page-cache keys of one level's blocks (for pin/unpin)."""
        b0, b1, _ = self._level_blocks(lvl)
        return [(self._cache_ns, b) for b in range(b0, b1 + 1)]

    def clip_level(self, buf: bytes, lvl: int, skip: int) -> bytes:
        """Clip a level's slab bytes out of its joined block payloads
        (shared by the synchronous fetch and the pipeline's assembly)."""
        if self.version >= 4:
            _off, length, _ = self.extents[lvl]
            return buf[skip:skip + length]
        return buf[:self.extents[lvl][2]]

    def _fetch(self, lvl: int, pin: bool) -> bytes:
        """One level's raw slab bytes via the page cache."""
        if self.version >= 4 and self.extents[lvl][1] == 0:
            return b""                  # zero-row level: nothing on disk
        b0, b1, skip = self._level_blocks(lvl)
        pin = pin or self.pin_blocks
        parts = [self.cache.get((self._cache_ns, b),
                                lambda b=b: self._load_block(b), pin=pin)
                 for b in range(b0, b1 + 1)]
        return self.clip_level(b"".join(parts), lvl, skip)

    def read_level(self, lvl: int, pin: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
        """One real level's ``(dst, src_idx, w, assoc, row_valid)`` slab
        at the full ``[M_pad, K_fix]`` rectangle (padding rows
        reconstructed from header defaults for compact v4 slabs),
        fetched block-by-block through the page cache."""
        if not 0 <= lvl < self.n_real:
            raise IndexError(f"{self.name}: level {lvl} out of range "
                             f"(0..{self.n_real - 1})")
        return self.parse_slab(self._fetch(lvl, pin), lvl)

    def parse_slab(self, buf: bytes, lvl: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
        """Decode one level's clipped slab bytes into the full
        ``[M_pad, K_fix]`` rectangle (see :meth:`read_level`)."""
        m, k = self.m_pad, self.k_fix
        m_real = self.extents[lvl][2] if self.version >= 4 else -1
        if m_real < 0:          # full rectangle with explicit valid vector
            off = 0
            dst = np.frombuffer(buf, np.int32, m, off); off += 4 * m
            valid = np.frombuffer(buf, np.uint8, m, off).astype(bool)
            off += m
            src = np.frombuffer(buf, np.int32, m * k, off).reshape(m, k)
            off += 4 * m * k
            w = np.frombuffer(buf, np.float32, m * k, off).reshape(m, k)
            off += 4 * m * k
            assoc = np.frombuffer(buf, np.int32, m * k, off).reshape(m, k)
            return dst, src, w, assoc, valid
        # compact slab: real-row prefix + reconstructed default padding
        dst = np.full(m, self.sentinel, np.int32)
        src = np.full((m, k), self.sentinel, np.int32)
        w = np.full((m, k), INF, np.float32)
        assoc = np.full((m, k), -1, np.int32)
        valid = np.zeros(m, bool)
        mr = m_real
        off = 0
        dst[:mr] = np.frombuffer(buf, np.int32, mr, off); off += 4 * mr
        src[:mr] = np.frombuffer(buf, np.int32, mr * k, off).reshape(mr, k)
        off += 4 * mr * k
        w[:mr] = np.frombuffer(buf, np.float32, mr * k, off).reshape(mr, k)
        off += 4 * mr * k
        assoc[:mr] = np.frombuffer(buf, np.int32, mr * k,
                                   off).reshape(mr, k)
        valid[:mr] = True
        return dst, src, w, assoc, valid

    def read_plan(self) -> SweepPlan:
        """Materialize the full plan (padding levels reconstructed from
        header defaults) — the non-streaming ``load_store`` path."""
        l_pad, m, k = self.l_pad, self.m_pad, self.k_fix
        if l_pad == 0:
            return _empty_plan(k)
        dst = np.full((l_pad, m), self.sentinel, np.int32)
        src = np.full((l_pad, m, k), self.sentinel, np.int32)
        w = np.full((l_pad, m, k), INF, np.float32)
        assoc = np.full((l_pad, m, k), -1, np.int32)
        row_valid = np.zeros((l_pad, m), bool)
        level_mask = np.zeros((l_pad,), bool)
        for lvl in range(self.n_real):
            d, s, w_l, a, v = self.read_level(lvl)
            dst[lvl], src[lvl], w[lvl], assoc[lvl] = d, s, w_l, a
            row_valid[lvl] = v
            level_mask[lvl] = True
        return SweepPlan(dst=dst, src_idx=src, w=w, assoc=assoc,
                         row_valid=row_valid, level_mask=level_mask)


@dataclasses.dataclass
class _PlanScanStats:
    rows: int
    edges: int


class IndexStore:
    """An open store directory: the resident tier as a plan-less
    :class:`HoDIndex` plus one :class:`SegmentReader` per sweep plan,
    all sharing one page cache and one metering device.

    ``pin_segments`` names the segments whose blocks are pinned into
    the cache on first read (default: the small ``plan_core`` — see
    :data:`PIN_SEGMENTS`); the cache's pin budget bounds how much can
    stick, so over-subscription degrades gracefully.  ``pin_frac``
    sizes that budget when the store builds its own default cache (it
    is an error to pass both ``cache`` and ``pin_frac`` — configure the
    cache directly instead)."""

    def __init__(self, path: str, device: Optional[BlockDevice] = None,
                 cache: Optional[PageCache] = None,
                 pin_segments: Optional[Sequence[str]] = PIN_SEGMENTS,
                 pin_frac: Optional[float] = None):
        if cache is not None and pin_frac is not None:
            raise ValueError("pass pin_frac on the PageCache itself "
                             "when supplying an explicit cache")
        resident = os.path.join(path, RESIDENT_FILE)
        if not os.path.isfile(resident):
            raise FileNotFoundError(
                f"{path}: not a HoD index store (no {RESIDENT_FILE})")
        self.path = path
        self._plan_scan: Dict[str, _PlanScanStats] = {}
        with np.load(resident) as z:
            self.block_bytes = int(z["block_bytes"])
            self.codec = str(z["codec"]) if "codec" in z else "raw"
            self.resident = HoDIndex._from_npz(z)
            for name in SEGMENT_NAMES:
                self._plan_scan[name] = _PlanScanStats(
                    rows=int(z[f"{name}_rows"]),
                    edges=int(z[f"{name}_edges"]))
        # A device that does not yet know its block size (the fleet's
        # routing façade is configured from store geometry *after* the
        # store opens) adopts the store's; a mismatched one is an error.
        dev_bb = getattr(device, "block_bytes", None)
        if device is not None and dev_bb is not None \
                and dev_bb != self.block_bytes:
            raise ValueError(
                f"{path}: metering device block size "
                f"({device.block_bytes}) != store block size "
                f"({self.block_bytes}) — I/O accounting would be wrong")
        self.device = device or BlockDevice(block_bytes=self.block_bytes)
        self.cache = (cache if cache is not None
                      else PageCache(pin_frac=pin_frac))
        #: back-reference set by ``ServingFleet`` when this store's
        #: cache/device are fleet routing façades; the read pipeline
        #: uses it to run on the shard workers' pools, and ``close()``
        #: shuts those workers down with the store.
        self.fleet = None
        pin_set = frozenset(pin_segments or ())
        self.segments: Dict[str, SegmentReader] = {}
        try:
            for i, name in enumerate(SEGMENT_NAMES):
                self.segments[name] = SegmentReader(
                    os.path.join(path, f"{name}.seg"),
                    base_block=i * _SEGMENT_ID_STRIDE, device=self.device,
                    cache=self.cache, name=name,
                    pin_blocks=name in pin_set)
        except Exception:
            self.close()    # don't leak fds of segments already opened
            raise

    # --------------------------------------------------------------- queries
    def n_real(self, name: str) -> int:
        return self.segments[name].n_real

    def read_level(self, name: str, lvl: int, pin: bool = False):
        return self.segments[name].read_level(lvl, pin=pin)

    def unpin_level(self, name: str, lvl: int) -> None:
        """Release a level's pin leases (no-op for blocks whose pin
        never stuck, and for sticky ``pin_segments`` readers).

        The affinity layout makes adjacent levels share their boundary
        block under ONE pin entry, so a shared block's lease is handed
        forward: it is excluded here and released when the *next* level
        is unpinned (or by the sweep-end ledger)."""
        seg = self.segments[name]
        if seg.pin_blocks:
            return      # segment-aware pins are sticky by design
        keys = set(seg.level_keys(lvl))
        if lvl + 1 < seg.n_real:
            keys -= set(seg.level_keys(lvl + 1))
        self.cache.unpin(keys)

    def read_plan(self, name: str) -> SweepPlan:
        return self.segments[name].read_plan()

    # ------------------------------------------------------------ accounting
    def store_bytes(self) -> int:
        """Total on-disk size of the store (resident + segments) — the
        denominator for ``cache_bytes`` budgets."""
        return (os.path.getsize(os.path.join(self.path, RESIDENT_FILE))
                + segment_bytes(self.path))

    def segment_bytes(self) -> int:
        """On-disk size of the streamed tier only (the three segments)."""
        return segment_bytes(self.path)

    def scan_bytes(self, sssp: bool = False,
                   core_mode: str = "closure") -> int:
        """Modeled compact-payload cost of one full sweep — the shared
        :func:`~repro_torch.core.index.scan_cost_bytes` model over the
        persisted row/edge counts, no plan materialization needed."""
        def plan_cost(name: str, include_assoc: bool) -> int:
            st = self._plan_scan[name]
            return scan_cost_bytes(st.rows, st.edges, include_assoc)
        total = plan_cost("plan_f", sssp) + plan_cost("plan_b", sssp)
        if sssp:
            total += plan_cost("plan_core", True)
        return total + core_scan_bytes(self.resident, core_mode)

    def segment_blocks(self) -> Dict[str, int]:
        """Per-segment logical data-block counts — the geometry the
        fleet partitioner splits (``fleet/``)."""
        return {name: seg.data_blocks()
                for name, seg in self.segments.items()}

    def close(self) -> None:
        for seg in self.segments.values():
            seg.close()
        if self.fleet is not None:
            self.fleet.shutdown_workers()


def segment_bytes(path: str) -> int:
    """On-disk size of a store's streamed tier (the three segment
    files) — compressed bytes for codec stores; pure
    ``os.path.getsize``, no store open needed.  For sizing a page-cache
    budget use :func:`segment_logical_bytes`: the cache meters
    *decompressed* bytes, so a fraction of the compressed on-disk size
    would silently shrink the effective budget by the compression
    ratio."""
    return sum(os.path.getsize(os.path.join(path, f"{name}.seg"))
               for name in SEGMENT_NAMES)


def segment_logical_bytes(path: str) -> int:
    """Decompressed (cache-side) footprint of a store's streamed tier:
    the data-region bytes a page cache would hold with every block
    resident.  Codec-independent — a ``delta`` store reports exactly
    the same figure as the ``raw`` store of the same index — which
    makes it the right denominator for ``cache_frac``-style budgets.
    Header/footer metadata (never cached) is excluded."""
    total = 0
    for name in SEGMENT_NAMES:
        p = os.path.join(path, f"{name}.seg")
        with open(p, "rb") as f:
            (magic, version, block_bytes, _n_real, _l, _m, _k, _s, _r,
             footer_off, footer_len) = _HEADER.unpack(f.read(_HEADER.size))
            if magic not in (MAGIC, _MAGIC_V4, _MAGIC_V3):
                raise ValueError(f"{p}: not a HoD segment file")
            if version >= 5:
                f.seek(footer_off)
                footer = json.loads(f.read(footer_len))
                total += block_bytes * len(footer["frames"])
            else:
                # v3/v4 store data uncompressed and block-aligned, so
                # the data region [block 1, footer) IS the footprint
                total += max(0, footer_off - block_bytes)
    return total


def open_store(path: str, device: Optional[BlockDevice] = None,
               cache: Optional[PageCache] = None) -> IndexStore:
    return IndexStore(path, device=device, cache=cache)


def load_store(path: str) -> HoDIndex:
    """Fully materialize a store back into an in-memory :class:`HoDIndex`
    (plans included, bit-exact) — the compatibility/inspection path; a
    serving deployment streams through :class:`IndexStore` instead."""
    store = IndexStore(path)
    try:
        ix = store.resident
        for name in SEGMENT_NAMES:
            setattr(ix, name, store.read_plan(name))
        return ix
    finally:
        store.close()
