"""Transformer building blocks of the port (the five LM archs: dense
GQA, gemma3's sliding window, and the MoE block).

Plain PyTorch mirrors of the JAX package's ``models/layers.py``, kept to
its algorithms and its rounding points (see each function), except
:func:`attention_decode`, which runs the hand-written ``flash_decode``
kernel (rolling window caches included).  Prefill and training
attention has no TPU kernel and stays plain: the same blockwise
running-softmax schedules as the JAX module (:func:`attention_causal`,
:func:`attention_window`), differentiated by autograd.  The MoE block's
expert products are batched matmuls, as the JAX module leaves them to
XLA.  The perf variant of causal attention comes later (``ROADMAP.md``
queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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


def attention_window(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, *,
                     q_positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Sliding-window causal GQA: position i attends (i - window, i].

    The JAX module's schedule: chunks of ``w = min(window, T)``
    positions, each query chunk against the previous KV chunk and its
    own (the first one's previous chunk is zeros at position -10**9),
    f32 scores and one softmax over the 2w keys.  q: [B, T, H, dh];
    k, v: [B, T, Kh, dh].  Returns [B, T, H, dh] in ``v``'s dtype.
    """
    b, t0, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    w = min(window, t0)
    dev = q.device
    pos = (torch.arange(t0, dtype=torch.int64, device=dev)
           if q_positions is None else q_positions.long())
    pad = (-t0) % w
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos = F.pad(pos, (0, pad), value=-(2 ** 30))
    t = t0 + pad
    q = q.reshape(b, t, kh, g, dh) * q_scale(dh, q.dtype)
    zk = torch.zeros_like(k[:, :w])
    far = torch.full((w,), -10 ** 9, dtype=pos.dtype, device=dev)
    outs = []
    for j in range(t // w):
        cur = slice(j * w, (j + 1) * w)
        prev = slice((j - 1) * w, j * w)
        kk = torch.cat([k[:, prev] if j else zk, k[:, cur]], dim=1)
        vv = torch.cat([v[:, prev] if j else zk, v[:, cur]], dim=1)
        kpos = torch.cat([pos[prev] if j else far, pos[cur]])
        qpi = pos[cur]
        sc = _gqa_scores(q[:, cur], kk)                 # [B,Kh,G,w,2w]
        mask = (qpi[:, None] >= kpos[None, :]) \
            & (qpi[:, None] - kpos[None, :] < w)
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(sc - m)
        se = torch.clamp(p.sum(dim=-1), min=1e-30)
        out = torch.einsum("bkgts,bskd->btkgd", p, vv.float())
        outs.append(out / se.permute(0, 3, 1, 2)[..., None])
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

    ``window``: a local layer's rolling cache of ``window`` slots (the
    JAX branch): the new K/V goes to slot ``cur_len % window`` and the
    kernel reads slots ``[0, min(cur_len, window - 1)]``.  Slot order
    does not matter to the softmax; RoPE was applied before caching.
    Returns (out [B, H, dh] in the cache dtype, k_cache, v_cache).
    """
    cur_len = int(cur_len)
    slot = cur_len if window is None else cur_len % window
    if cur_len < 0 or slot >= k_cache.shape[1]:
        raise ValueError(f"attention_decode: slot {slot} is outside the "
                         f"cache of {k_cache.shape[1]} positions")
    kv_len = cur_len + 1 if window is None else min(cur_len, window - 1) + 1
    k_cache[:, slot] = k_new
    v_cache[:, slot] = v_new
    out = flash_decode(q, k_cache, v_cache, kv_len)
    return out.to(v_cache.dtype), k_cache, v_cache


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    """x: [..., D]; wg/wu: [D, F]; wd: [F, D].  ``silu`` is spelled
    ``h * (1 / (1 + exp(-h)))``, one rounding per operation: XLA's
    expansion of ``jax.nn.silu``, so bf16 results keep its bits."""
    return (_silu(x @ wg) * (x @ wu)) @ wd


def _silu(h: torch.Tensor) -> torch.Tensor:
    return h * (1.0 / (1.0 + torch.exp(-h)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


def moe_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert takes: ``ceil(T k cf / E)`` rounded up to a
    multiple of 8, at least 8 (the JAX block's formula)."""
    cap = int(-(-n_tokens * cfg.top_k * cfg.capacity_factor
                // cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


class MoERoute(NamedTuple):
    """Where each token's top-k choices go, each ``[T, k]`` with a
    token's choices in ascending expert order: ``gate`` (f32, the
    renormalised top-k probabilities), ``expert``, ``slot`` (its row of
    the ``[E * cap + 1, D]`` dispatch buffer; the last row takes the
    drops), ``keep`` (False where the choice came past ``cap``), and the
    0-d f32 ``aux`` loss (Switch: coef x E x sum_e f_e p_e)."""
    gate: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int
    aux: torch.Tensor


def moe_route(xt: torch.Tensor, router_w: torch.Tensor,
              cfg: MoEConfig) -> MoERoute:
    """The JAX block's routing for tokens ``xt`` [T, D]: f32 router,
    softmax, top-k, gates renormalised; a stable sort by expert gives
    each choice its place in its expert's queue (token order), and
    places at or past the capacity drop.  Device ops only (no host
    sync): counts by ``scatter_add_``, places by ``cumsum``."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)   # [T, E]
    gate, eid = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # a token's choices in expert order: the order JAX's scatter-add of
    # the combine meets them in (its updates are sorted by expert)
    eid, perm = torch.sort(eid, dim=-1)
    gate = torch.gather(gate, -1, perm)
    fe = eid.reshape(-1)
    counts = torch.zeros(e, dtype=fe.dtype, device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe))
    aux = (cfg.router_aux_coef * e) * torch.sum(
        probs.mean(dim=0) * (counts.float() / (t * k)))
    cap = moe_capacity(t, cfg)
    order = torch.argsort(fe, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    place_sorted = torch.arange(t * k, device=fe.device) - starts[fe[order]]
    place = torch.empty_like(place_sorted).scatter_(0, order, place_sorted)
    keep = place < cap
    slot = torch.where(keep, fe * cap + place, e * cap)
    return MoERoute(gate, eid, slot.reshape(t, k), keep.reshape(t, k), cap,
                    aux)


def moe_block(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, cfg: MoEConfig):
    """Sort-based top-k MoE on one device (the JAX block without its
    expert sharding).  x: [B, S, D]; router_w: [D, E]; wg/wu: [E, D, F];
    wd: [E, F, D].  Returns (y [B, S, D] in x's dtype, aux 0-d f32).

    Each expert runs its SwiGLU over a ``[cap, D]`` buffer of its
    tokens (zero rows where it has fewer).  The combine is
    deterministic and in JAX's order: a token's k outputs, each times
    its gate rounded to x's dtype, are added left to right in ascending
    expert order onto zeros, rounding after each add, as XLA's
    scatter-add does; no atomics, so bf16 bits repeat run to run."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    r = moe_route(xt, router_w, cfg)
    # each choice's token row into its slot of a zero buffer; the drops
    # all land on the scrap row e * cap, cut off below.  (Put, not a
    # gather from a zero row: the gather's backward would add every
    # empty slot's gradient into that one row, serially.)
    rows = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xt.new_zeros(e * r.cap + 1, d).index_put(
        (r.slot.reshape(-1),), rows)
    hb = buf[:e * r.cap].reshape(e, r.cap, d)
    h = _silu(torch.bmm(hb, wg)) * torch.bmm(hb, wu)
    ob = torch.bmm(h, wd).reshape(e * r.cap, d)
    ob = torch.cat([ob, ob.new_zeros(1, d)])
    w = torch.where(r.keep, r.gate, 0.0).to(ob.dtype)
    # a gather whose backward is an index_add_ (the drops' gradients
    # all meet on the scrap row; atomics take them at once)
    contrib = torch.index_select(ob, 0, r.slot.reshape(-1)).reshape(
        t, k, d) * w[..., None]                              # [T, k, D]
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), r.aux
