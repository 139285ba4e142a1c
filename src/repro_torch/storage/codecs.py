"""Per-block segment codecs (format v5, DESIGN.md §6).

A copy of the JAX package's ``storage/codecs.py`` (numpy only), so
segments written by either package are byte-identical.

A v5 segment frames every data block as ``(codec_id, comp_len, crc)``
+ compressed payload; this module is the codec registry both the writer
(`blockfile._write_segment`) and the reader (`SegmentReader._load_block`)
go through.  Three codecs:

* ``raw`` — identity (the v4-equivalent payload, just framed);
* ``delta`` — int32 id streams become delta + zigzag varints, float32
  weight streams stay raw (``delta+raw-weights``).  **Lossless**: every
  decoded block is byte-identical to its input, so SSD/SSSP answers
  from a ``delta`` store are bit-identical to a ``raw`` one
  (tests/test_codecs.py asserts both);
* ``f16`` — ids as in ``delta``, plus weight narrowing: a float32
  weight is stored as float16 only when the round trip reproduces it
  exactly or within :data:`F16_EPS_REL` relative error; every other
  weight (including NaN and out-of-f16-range magnitudes) falls back to
  a bit-exact float32 exception slot.  Distances from an ``f16`` store
  therefore agree with the exact engine to ~``L * F16_EPS_REL``
  relative error (L = sweep depth), never worse per edge than the
  documented eps.

**Typed spans.**  A block's payload is an arbitrary byte window of the
affinity-packed logical stream, so the codec is steered by a *span
map* derived from the footer's level extents: each byte range is
tagged ``i32`` (dst/src/assoc id words), ``f32`` (weight words), or
``raw`` (anything untyped: fallback slabs, trailing block padding).
Spans are cut at block boundaries; id/weight fragments that would
split a 4-byte word across two blocks are re-tagged ``raw`` at the
edges, so every block still encodes and decodes independently —
random block access (the page cache's unit) never needs a neighbor.

Per-block fallback: when a codec fails to shrink a block, the writer
keeps the raw payload and stamps the frame ``raw`` — ``codec_id`` is
per *frame*, not per segment, so a store never pays expansion for
incompressible blocks.

Everything here is vectorized numpy (no per-byte Python loops): varint
encode/decode touch each of the ≤5 byte positions once over the whole
word array.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CODEC_IDS", "CODEC_NAMES", "F16_EPS_REL", "Span",
           "block_spans", "decode_block", "encode_block", "level_spans",
           "vint_decode", "vint_encode"]

#: codec name -> frame codec_id (stable on-disk values; append-only).
CODEC_IDS: Dict[str, int] = {"raw": 0, "delta": 1, "f16": 2}
CODEC_NAMES: Dict[int, str] = {v: k for k, v in CODEC_IDS.items()}

#: f16 narrowing policy: a weight may be stored as float16 iff the
#: f32→f16→f32 round trip is exact or within this *relative* error
#: (float16 carries ~2^-11 ≈ 4.9e-4 relative precision, so normal-range
#: weights narrow; everything else — NaN, overflow to inf, subnormal
#: precision loss beyond eps — is stored as a bit-exact f32 exception).
F16_EPS_REL = 1e-3

#: span kinds — (kind, start, end) with absolute logical byte offsets.
KIND_I32 = "i32"
KIND_F32 = "f32"
KIND_RAW = "raw"
Span = Tuple[str, int, int]

_U32 = np.dtype("<u4")


# ------------------------------------------------------------- span maps
def level_spans(off: int, length: int, m_real: int,
                k_fix: int) -> List[Span]:
    """Typed spans of one level slab at logical offset ``off``.

    Mirrors ``blockfile._level_slab``: a compact slab (``m_real >= 0``)
    is ``dst[i32 m] · src[i32 m·K] · w[f32 m·K] · assoc[i32 m·K]``; the
    lossless fallback layout (explicit valid vector) is left untyped.
    """
    if length == 0:
        return []
    if m_real < 0:
        return [(KIND_RAW, off, off + length)]
    m, k = m_real, k_fix
    a = off
    spans = [(KIND_I32, a, a + 4 * m)]
    a += 4 * m
    spans.append((KIND_I32, a, a + 4 * m * k))
    a += 4 * m * k
    spans.append((KIND_F32, a, a + 4 * m * k))
    a += 4 * m * k
    spans.append((KIND_I32, a, a + 4 * m * k))
    a += 4 * m * k
    if a != off + length:
        raise ValueError(
            f"slab geometry mismatch: {a - off} != {length} bytes")
    return spans


def block_spans(spans: Sequence[Span], lo: int, hi: int,
                starts: Optional[Sequence[int]] = None) -> List[Span]:
    """Cut a segment's span map down to one block's payload ``[lo, hi)``.

    Returns block-*relative* spans covering ``[0, hi - lo)`` exactly:
    typed spans are clipped to the window and trimmed inward to 4-byte
    word phase (relative to the span's own start), with the clipped
    word fragments — and every untyped gap — emitted as ``raw``.

    ``starts`` is the optional precomputed ``[s for _, s, _ in spans]``
    list: spans are sorted and non-overlapping, so a bisect skips
    straight to the window instead of scanning every span — O(log L +
    spans-in-block) per call, which keeps repeated cache misses cheap
    on deep-level segments (callers on the miss path pass it).
    """
    out: List[Span] = []
    pos = lo
    if starts is not None:
        # first span that could reach into [lo, hi): the one before the
        # first start > lo (it may straddle lo), clamped to 0
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        spans = spans[i:]

    def emit(kind: str, start: int, end: int) -> None:
        nonlocal pos
        if start > pos:
            out.append((KIND_RAW, pos - lo, start - lo))
        if end > start:
            out.append((kind, start - lo, end - lo))
        pos = max(pos, end)

    for kind, s, e in spans:
        if s >= hi:
            break                   # sorted: nothing later can intersect
        a, b = max(s, lo), min(e, hi)
        if a >= b:
            continue
        if kind == KIND_RAW:
            emit(KIND_RAW, a, b)
            continue
        # snap inward to the span's word phase so no i32/f32 word is
        # split across blocks; edge fragments go raw
        wa = s + -(-(a - s) // 4) * 4
        wb = s + ((b - s) // 4) * 4
        if wb <= wa:
            emit(KIND_RAW, a, b)
            continue
        if wa > a:
            emit(KIND_RAW, a, wa)
        emit(kind, wa, wb)
        if b > wb:
            emit(KIND_RAW, wb, b)
    if pos < hi:
        out.append((KIND_RAW, pos - lo, hi - lo))
    return out


# --------------------------------------------------------------- varints
def vint_encode(values: np.ndarray) -> bytes:
    """Zigzag + LEB128-style varint encode an int64 array (vectorized).

    Values must fit zigzag in 35 bits — always true for int32 payloads
    and their first-order deltas (|delta| < 2^32 → zigzag < 2^33).
    """
    v = np.asarray(values, np.int64)
    if v.size == 0:
        return b""
    z = ((v << 1) ^ (v >> 63)).view(np.uint64)
    nb = np.ones(v.size, np.int64)
    for t in (7, 14, 21, 28):
        nb += z >= (np.uint64(1) << np.uint64(t))
    if z.max() >= (1 << 35):
        raise ValueError("varint overflow: value exceeds 35 zigzag bits")
    ends = np.cumsum(nb)
    starts = ends - nb
    out = np.empty(int(ends[-1]), np.uint8)
    for j in range(5):
        m = nb > j
        if not m.any():
            break
        byte = ((z[m] >> np.uint64(7 * j)) & np.uint64(0x7F))
        cont = (nb[m] - 1 > j).astype(np.uint8) << 7
        out[starts[m] + j] = byte.astype(np.uint8) | cont
    return out.tobytes()


def vint_decode(buf: bytes, count: int) -> np.ndarray:
    """Inverse of :func:`vint_encode`: exactly ``count`` int64 values."""
    if count == 0:
        if buf:
            raise ValueError("varint stream has trailing bytes")
        return np.empty(0, np.int64)
    b = np.frombuffer(buf, np.uint8)
    ends = np.flatnonzero((b & 0x80) == 0)
    if ends.size != count or (ends.size and ends[-1] != b.size - 1):
        raise ValueError(
            f"varint stream: {ends.size} terminators for {count} values")
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    if lens.max() > 5:
        raise ValueError("varint stream: value longer than 5 bytes")
    z = np.zeros(count, np.uint64)
    for j in range(5):
        m = lens > j
        if not m.any():
            break
        z[m] |= ((b[starts[m] + j] & 0x7F).astype(np.uint64)
                 << np.uint64(7 * j))
    return (z >> np.uint64(1)).view(np.int64) ^ -(z & np.uint64(1)
                                                  ).view(np.int64)


# ------------------------------------------------------------ span coding
def _encode_i32(raw: bytes) -> bytes:
    words = np.frombuffer(raw, "<i4").astype(np.int64)
    deltas = np.diff(words, prepend=np.int64(0))
    return vint_encode(deltas)


def _decode_i32(enc: bytes, raw_len: int) -> bytes:
    deltas = vint_decode(enc, raw_len // 4)
    words = np.cumsum(deltas)
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if words.size and (words.min() < lo or words.max() > hi):
        raise ValueError("corrupt delta stream: int32 overflow")
    return words.astype("<i4").tobytes()


def _encode_f16(raw: bytes) -> bytes:
    w = np.frombuffer(raw, "<f4")
    with np.errstate(over="ignore", invalid="ignore"):
        back = w.astype(np.float16).astype(np.float32)
        keep = (back == w) | (np.abs(back - w) <= F16_EPS_REL * np.abs(w))
    exc = ~keep
    return b"".join((
        np.array([int(exc.sum())], _U32).tobytes(),
        np.packbits(exc).tobytes(),
        w[keep].astype("<f2").tobytes(),
        np.ascontiguousarray(w[exc], "<f4").tobytes()))


def _decode_f16(enc: bytes, raw_len: int) -> bytes:
    n = raw_len // 4
    n_exc = int(np.frombuffer(enc, _U32, 1, 0)[0])
    bm_len = -(-n // 8)
    exc = np.unpackbits(
        np.frombuffer(enc, np.uint8, bm_len, 4))[:n].astype(bool)
    if int(exc.sum()) != n_exc:
        raise ValueError("corrupt f16 stream: exception count mismatch")
    off = 4 + bm_len
    narrow = np.frombuffer(enc, "<f2", n - n_exc, off)
    off += 2 * (n - n_exc)
    exact = np.frombuffer(enc, "<f4", n_exc, off)
    out = np.empty(n, "<f4")
    out[~exc] = narrow.astype(np.float32)
    out[exc] = exact
    return out.tobytes()


# ------------------------------------------------------------ block frame
def _code_spans(payload: bytes, spans: Iterable[Span],
                weights: str) -> bytes:
    """Encode a block: per span, ``u32 enc_len`` + encoded bytes.

    ``weights`` picks the f32 treatment: ``"raw"`` (lossless delta
    codec) or ``"f16"`` (narrowing).
    """
    parts = []
    for kind, lo, hi in spans:
        raw = payload[lo:hi]
        if kind == KIND_I32:
            enc = _encode_i32(raw)
        elif kind == KIND_F32 and weights == "f16":
            enc = _encode_f16(raw)
        else:
            enc = raw
        parts.append(np.array([len(enc)], _U32).tobytes())
        parts.append(enc)
    return b"".join(parts)


def encode_block(codec: str, payload: bytes,
                 spans: Sequence[Span]) -> Tuple[int, bytes]:
    """Encode one block payload; returns ``(codec_id, blob)``.

    Falls back to ``raw`` framing whenever the requested codec does not
    strictly shrink the payload, so a frame never expands past raw + 0.
    """
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown codec {codec!r} "
                         f"(have {sorted(CODEC_IDS)})")
    if codec != "raw":
        blob = _code_spans(payload, spans,
                           "f16" if codec == "f16" else "raw")
        if len(blob) < len(payload):
            return CODEC_IDS[codec], blob
    return CODEC_IDS["raw"], payload


def decode_block(codec_id: int, blob: bytes, spans: Sequence[Span],
                 raw_len: int) -> bytes:
    """Inverse of :func:`encode_block` for one frame."""
    name = CODEC_NAMES.get(codec_id)
    if name is None:
        raise ValueError(f"unknown frame codec_id {codec_id}")
    if name == "raw":
        if len(blob) != raw_len:
            raise ValueError("corrupt raw frame: length mismatch")
        return blob
    out = []
    off = 0
    for kind, lo, hi in spans:
        enc_len = int(np.frombuffer(blob, _U32, 1, off)[0])
        off += 4
        enc = blob[off:off + enc_len]
        if len(enc) != enc_len:
            raise ValueError("corrupt frame: truncated span")
        off += enc_len
        if kind == KIND_I32:
            out.append(_decode_i32(enc, hi - lo))
        elif kind == KIND_F32 and name == "f16":
            out.append(_decode_f16(enc, hi - lo))
        else:
            if enc_len != hi - lo:
                raise ValueError("corrupt frame: raw span length mismatch")
            out.append(enc)
    data = b"".join(out)
    if len(data) != raw_len or off != len(blob):
        raise ValueError("corrupt frame: decoded length mismatch")
    return data
