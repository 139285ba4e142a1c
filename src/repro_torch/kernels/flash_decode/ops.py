"""Wrapper of the split-KV decode attention kernel
(``csrc/flash_decode.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.
"""
import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import note_fake_launch
from .._build import load
from .ref import flash_decode_ref, q_scale

__all__ = ["flash_decode", "plan_splits", "flash_decode_cost"]

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float] \
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]

#: KV positions a block stages per step; a split covers whole tiles.
TILE = 64
#: The SIMT form keeps G*dh/256 float4 accumulators a thread, at most 4
#: (the tensor-core form, bf16 caches with G <= 16 and dh <= 256, stays
#: within it).
MAX_G_DH = 4096


def plan_splits(b: int, kh: int, n_valid: int, sms: int,
                blocks_per_sm: int) -> "tuple[int, int]":
    """``(n_split, split_len)``: cut ``[0, n_valid)`` of each of the
    ``b * kh`` (batch row, group of KV heads a block takes) units into
    ``n_split`` splits of ``split_len`` positions (whole tiles; the last
    split may be shorter, none is empty).  The pass is bound by bytes, so
    every block should stream from the start to the end of the call: as
    many splits as keep all blocks resident in one wave of
    ``sms * blocks_per_sm`` slots, and all of one length.  glm4's
    decode_32k layer (b 32, both KV heads in a block, n_valid 32761) on
    132 SMs x 1: 4 splits of 8192 positions, 128 blocks; gemma3's (b 16,
    one of 8 KV heads a block at dh 256): 1 split, 128 blocks; its
    long_500k layer (b 1, n_valid 524281): 16 splits of 32768."""
    if min(b, kh, n_valid, sms, blocks_per_sm) < 1:
        raise ValueError(f"plan_splits: needs positive sizes, got b={b} "
                         f"kh={kh} n_valid={n_valid} sms={sms} "
                         f"blocks_per_sm={blocks_per_sm}")
    tiles = -(-n_valid // TILE)
    n_split = max(1, min(tiles, sms * blocks_per_sm // (b * kh)))
    split_tiles = -(-tiles // n_split)
    return -(-tiles // split_tiles), split_tiles * TILE


def flash_decode_cost(b: int, h: int, kh: int, dh: int, kv_len: int,
                      cache_bytes: int = 2, q_bytes: int = 2
                      ) -> "tuple[int, int]":
    """(bytes, operations) of one call: the K and V rows below
    ``kv_len`` (``cache_bytes`` an element) read once, q in (``q_bytes``)
    and the f32 output written; a multiply and an add per (head,
    position, column) for QK and for PV.  The products run on the
    tensor cores over bf16 caches."""
    return (2 * b * kh * kv_len * dh * cache_bytes + b * h * dh * (q_bytes + 4),
            4 * b * h * kv_len * dh)


@functools.lru_cache(maxsize=None)
def _device_config(index: int, kv_bf16: bool, q_bf16: bool, kh: int, g: int,
                   dh: int) -> "tuple[int, int, int, int, int, int]":
    """(SMs, resident blocks a SM, shared memory bytes a block, ring
    stages, tensor-core dh or 0 for SIMT, KV heads a block) of the split
    pass that a call of this kind takes on CUDA device ``index``; asked
    once."""
    with torch.cuda.device(index):
        buf = (ctypes.c_int * 5)()
        err = load("flash_decode").flash_decode_config(
            int(kv_bf16), int(q_bf16), kh, g, dh, buf)
        if err:
            raise RuntimeError(f"flash_decode: occupancy query failed: CUDA "
                               f"error {err}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (sms, *buf)


def device_config(q: torch.Tensor, k_cache: torch.Tensor):
    """:func:`_device_config` for these CUDA tensors."""
    index = q.device.index
    return _device_config(torch.cuda.current_device() if index is None
                          else index, k_cache.dtype == torch.bfloat16,
                          q.dtype == torch.bfloat16, k_cache.shape[2],
                          q.shape[1] // k_cache.shape[2], q.shape[2])


def _check(q, k_cache, v_cache) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode: q must be on the CPU or a CUDA "
                         f"device, got {dev}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev:
            raise ValueError(f"flash_decode: {name} is on {t.device}, q on "
                             f"{dev}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"flash_decode: {name} must be float32 or "
                             f"bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             f"16-byte aligned")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError("flash_decode: k_cache and v_cache dtypes differ")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    b, h, dh = q.shape
    if dh % 8 or dh > 256 or h * dh // k_cache.shape[2] > MAX_G_DH:
        raise ValueError(f"flash_decode: the kernel takes dh a multiple of 8 "
                         f"up to 256 and G*dh <= {MAX_G_DH}; got dh={dh}, "
                         f"G={h // k_cache.shape[2]}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """One-token GQA attention over a KV cache:

        out[b, kh*G + g] = softmax_s<kv_len(q'[b, kh*G + g] . k[b, s, kh])
                           @ v[b, :kv_len, kh]

    with ``q' = q * dh**-0.5`` rounded to ``q``'s dtype.  q: [B, H, dh]
    f32 or bf16; caches: [B, S, Kh, dh] f32 or bf16, H a multiple of Kh;
    ``1 <= kv_len`` (positions >= min(kv_len, S) are masked).  Returns
    [B, H, dh] f32.  ``flash_decode.launches`` counts calls of the
    kernel's entry point (its split pass and their combine).
    """
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: q must be [B, H, dh] and both caches "
                         f"[B, S, Kh, dh]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, dh = q.shape
    _, s, kh, dhc = k_cache.shape
    if k_cache.shape[0] != b or dhc != dh or h % kh:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit the "
                         f"cache {tuple(k_cache.shape)}")
    kv_len = int(kv_len)
    if kv_len < 1:
        raise ValueError(f"flash_decode: kv_len must be >= 1, got {kv_len}")
    if q.device.type == "cpu" and k_cache.device.type == "cpu" \
            and v_cache.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, kv_len)
    if isinstance(q, FakeTensor):
        return _fake(q, k_cache, kv_len)
    return _launch(q, k_cache, v_cache, kv_len)


def _fake(q: torch.Tensor, k_cache: torch.Tensor,
          kv_len: int) -> torch.Tensor:
    """The kernel's fake form: its output, and the call reported with
    :func:`flash_decode_cost` (products in the caches' dtype)."""
    b, h, dh = q.shape
    _, s, kh, _ = k_cache.shape
    note_fake_launch("flash_decode", *flash_decode_cost(
        b, h, kh, dh, min(kv_len, s), k_cache.element_size(),
        q.element_size()), k_cache.dtype)
    return torch.empty((b, h, dh), dtype=torch.float32, device=q.device)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            kv_len: int, n_split: int = None) -> torch.Tensor:
    """The kernel on CUDA tensors, cut as :func:`plan_splits` plans;
    ``n_split`` forces another count (for the card tests of the splits'
    edges)."""
    _check(q, k_cache, v_cache)
    b, h, dh = q.shape
    _, s, kh, _ = k_cache.shape
    g = h // kh
    n_valid = min(int(kv_len), s)
    sms, per_sm, *_, heads = device_config(q, k_cache)
    if n_split is None:
        n_split, split_len = plan_splits(b, kh // heads, n_valid, sms, per_sm)
    else:
        tiles = -(-n_valid // TILE)
        split_len = -(-tiles // n_split) * TILE
        n_split = -(-n_valid // split_len)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    part_acc = torch.empty(b * kh * n_split * g * dh, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(2 * b * kh * n_split * g, dtype=torch.float32,
                          device=q.device)
    qc = q.contiguous()
    fn = load("flash_decode").flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(qc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
             int(k_cache.dtype == torch.bfloat16),
             int(q.dtype == torch.bfloat16), q_scale(dh, q.dtype), b, s, kh,
             g, dh, n_valid, n_split, split_len,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
