"""Wrapper of the split-KV decode attention kernel
(``csrc/flash_decode.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Nothing falls back from one to the other.
"""
import ctypes

import torch

from .._build import load
from .ref import flash_decode_ref, q_scale

__all__ = ["flash_decode"]

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

#: KV positions a block stages per step; a split covers whole tiles.
TILE = 64
#: Blocks of the split pass resident on one SM (their shared memory,
#: ~81 KB at dh=128 in either form, allows two); the split count fills
#: one wave.
BLOCKS_PER_SM = 2
#: The SIMT form keeps G*dh/256 float4 accumulators a thread, at most 4
#: (the tensor-core form, bf16 caches with G <= 16, stays below).
MAX_G_DH = 4096


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
    _check(q, k_cache, v_cache)
    g = h // kh
    n_valid = min(kv_len, s)
    tiles = -(-n_valid // TILE)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = max(1, min(tiles, BLOCKS_PER_SM * sms // (b * kh)))
    split_tiles = -(-tiles // n_split)
    n_split = -(-tiles // split_tiles)
    # q is scaled in its own dtype (JAX's rounding), then widened exactly.
    qs = (q * q_scale(dh, q.dtype)).float().contiguous()
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    part_acc = torch.empty(b * kh * n_split * g * dh, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(2 * b * kh * n_split * g, dtype=torch.float32,
                          device=q.device)
    fn = load("flash_decode").flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(qs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
             int(k_cache.dtype == torch.bfloat16), b, s, kh, g, dh,
             n_valid, n_split, split_tiles * TILE,
             1 if q.dtype == torch.bfloat16 else 3,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
