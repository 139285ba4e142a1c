"""Transformer building blocks of the port (what glm4 serving and
training need).

Plain PyTorch mirrors of the JAX package's ``models/layers.py``, kept to
its algorithms and its rounding points (see each function), except
:func:`attention_decode`, which runs the hand-written ``flash_decode``
kernel.  Prefill and training attention has no TPU kernel and stays
plain: the same blockwise running-softmax schedule as the JAX module,
differentiated by autograd.  Sliding-window
attention, the perf variant of causal attention and the MoE block come
with the archs that need them (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_decode import flash_decode, q_scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin of the RoPE angles, f32 [..., T, 1, head_dim/2], for
    positions [..., T] (int).  A model computes them once a call and
    rotates every layer's q and k with :func:`rotate`."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim] rotated by :func:`rope_cos_sin`'s
    tables, computed in f32 (a bf16 ``x`` times the f32 cos/sin
    promotes, as in JAX) and cast back to ``x``'s dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim]; positions: [..., T] (int)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, T, Kh, G, dh]; k: [B, Sk, Kh, dh] -> [B, Kh, G, T, Sk] f32
    (JAX's ``preferred_element_type=f32``: bf16 products are exact in f32,
    so widening first gives the same sums)."""
    return torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())


def attention_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     chunk: int = 1024,
                     q_positions: Optional[torch.Tensor] = None,
                     kv_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Exact causal GQA with a flash-style running softmax over KV chunks.

    q: [B, T, H, dh]; k, v: [B, S, Kh, dh].  Returns [B, T, H, dh] (f32
    accumulation, cast back to ``v``'s dtype).  Blocks above the
    diagonal are masked, not skipped, as in the JAX module.
    """
    b, t0, h, dh = q.shape
    s0, kh = k.shape[1], k.shape[2]
    g = h // kh
    cq = min(chunk, t0)
    ck = min(chunk, s0)
    dev = q.device
    qpos = (torch.arange(t0, dtype=torch.int32, device=dev)
            if q_positions is None else q_positions)
    kpos = (torch.arange(s0, dtype=torch.int32, device=dev)
            if kv_positions is None else kv_positions)
    # Pad ragged tails to chunk multiples; padded KV positions are +BIG so
    # no real query attends them, padded query rows are sliced off below.
    pad_t, pad_s = (-t0) % cq, (-s0) % ck
    if pad_t:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_t))
        qpos = F.pad(qpos, (0, pad_t), value=-1)
    if pad_s:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_s))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_s))
        kpos = F.pad(kpos, (0, pad_s), value=2 ** 30)
    t, s = t0 + pad_t, s0 + pad_s
    q = q.reshape(b, t, kh, g, dh) * q_scale(dh, q.dtype)
    neg_inf = float("-inf")

    outs = []
    for i in range(t // cq):
        qi, qpi = q[:, i * cq:(i + 1) * cq], qpos[i * cq:(i + 1) * cq]
        m = torch.full((b, kh, g, cq), neg_inf, device=dev)
        se = torch.zeros((b, kh, g, cq), device=dev)
        acc = torch.zeros((b, cq, kh, g, dh), device=dev)
        for j in range(s // ck):
            sl = slice(j * ck, (j + 1) * ck)
            ki, vi, kpi = k[:, sl], v[:, sl], kpos[sl]
            sc = _gqa_scores(qi, ki)                       # [B,Kh,G,cq,ck]
            causal = qpi[:, None] >= kpi[None, :]
            sc = sc.masked_fill(~causal, neg_inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sc - m_safe[..., None])
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            se = se * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgts,bskd->btkgd", p, vi.float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        se = torch.clamp(se, min=1e-30)
        outs.append(acc / se.permute(0, 3, 1, 2)[..., None])
    out = torch.cat(outs, dim=1).reshape(b, t, h, dh)
    return out[:, :t0].to(v.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cur_len: int,
                     *, window: Optional[int] = None):
    """One-token GQA over a KV cache, through the ``flash_decode`` kernel.

    q: [B, H, dh]; caches: [B, Smax, Kh, dh]; k_new/v_new: [B, Kh, dh]
    (already RoPE'd).  Entries [0, cur_len) are valid; the new K/V is
    written at slot ``cur_len`` *in place* (the JAX decode cell donates
    its caches) before attending, so the token attends to itself.
    Returns (out [B, H, dh] in the cache dtype, k_cache, v_cache).
    """
    if window is not None:
        raise NotImplementedError(
            "rolling sliding-window caches come with window attention "
            "(ROADMAP.md queue 1)")
    cur_len = int(cur_len)
    if not 0 <= cur_len < k_cache.shape[1]:
        raise ValueError(f"attention_decode: slot {cur_len} is outside the "
                         f"cache of {k_cache.shape[1]} positions")
    k_cache[:, cur_len] = k_new
    v_cache[:, cur_len] = v_new
    out = flash_decode(q, k_cache, v_cache, cur_len + 1)
    return out.to(v_cache.dtype), k_cache, v_cache


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    """x: [..., D]; wg/wu: [D, F]; wd: [F, D].  ``silu`` is spelled
    ``h * (1 / (1 + exp(-h)))``, one rounding per operation: XLA's
    expansion of ``jax.nn.silu``, so bf16 results keep its bits."""
    hg = x @ wg
    return (hg * (1.0 / (1.0 + torch.exp(-hg))) * (x @ wu)) @ wd
