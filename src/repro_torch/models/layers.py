"""Transformer building blocks of the port (the five LM archs: dense
GQA, gemma3's sliding window, and the MoE block).

Plain PyTorch mirrors of the JAX package's ``models/layers.py``, kept to
its algorithms and its rounding points (see each function), except
:func:`attention_decode`, which runs the hand-written ``flash_decode``
kernel (rolling window caches included).  Prefill and training
attention has no TPU kernel and stays plain: the same blockwise
running-softmax schedules as the JAX module (:func:`attention_causal`,
:func:`attention_window`), differentiated by autograd.  The optimized
LM variant's training attention, :func:`attention_causal_opt` (flat GQA
heads, bf16 probabilities), gives its products operands in the
compute dtype and f32 results (:func:`matmul_f32`: the tensor cores on
the card).  The MoE block's expert products are batched matmuls, as the
JAX module leaves them to XLA.

Under an active mesh (``shardlib.axis_rules``) the decode attention and
the MoE block take the JAX module's shard_map branches on local blocks:
split-KV decode over a sequence-sharded cache, in plain torch as JAX's
mapped body is plain array math, and expert-parallel MoE over the
rank's experts.  Each joins the ranks with ``psum``/``pmax`` over the
tensor-parallel axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import shardlib as sl
from ..kernels.flash_decode import flash_decode, q_scale
from ..shardlib import P

DP = "batch"        # logical data-parallel axis (('pod','data') on the mesh)
TP = "model_dim"    # logical tensor-parallel axis ('model' on the mesh)


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


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two 3-d bf16 (or f16) CUDA tensors with f32 results
    (``torch.bmm(..., out_dtype=float32)``, which has no derivative).  Its
    backward takes the f32 cotangent rounded to the operands' dtype, so
    the gradient products run on the tensor cores too, and returns
    gradients in that dtype, as JAX's transpose of the product does
    (XLA on a TPU rounds the cotangent the same way at its default
    precision)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.mT), torch.bmm(a.mT, g)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` ([..., m, k] x [..., k, n]) with f32 results,
    JAX's ``preferred_element_type=f32``.  f32 operands multiply as they
    are.  Otherwise the device decides: on the card the operands stay in
    their dtype (:class:`_MatmulF32`); on the CPU they are widened first,
    which gives the same values, since a bf16 product is exact in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.device.type == "cpu":
        return a.float() @ b.float()
    lead = a.shape[:-2]
    out = _MatmulF32.apply(a.reshape(-1, *a.shape[-2:]),
                           b.reshape(-1, *b.shape[-2:]))
    return out.reshape(*lead, *out.shape[-2:])


def attention_causal_opt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, chunk: int = 1024,
                         q_positions: Optional[torch.Tensor] = None,
                         kv_positions: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The optimized variant's exact causal GQA (the JAX module's
    ``attention_causal_opt``): the schedule of :func:`attention_causal`,
    with the KV heads repeated to the flat query-head axis (head ``h``
    reads KV head ``h // G``), scores from operands in q's dtype with f32
    results, and ``p = exp(sc - m)`` cast to v's dtype before its row sum
    (summed in f32, rounded to v's dtype, widened) and before PV (f32
    results).  ``m``, the sum and the accumulator stay f32.  q: [B, T,
    H, dh]; k, v: [B, S, Kh, dh].  Returns [B, T, H, dh] in v's dtype.
    The JAX function's sharding annotations are no-ops on one device
    and are left out."""
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
    pad_t, pad_s = (-t0) % cq, (-s0) % ck
    if pad_t:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_t))
        qpos = F.pad(qpos, (0, pad_t), value=-1)
    if pad_s:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_s))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_s))
        kpos = F.pad(kpos, (0, pad_s), value=2 ** 30)
    t, s = t0 + pad_t, s0 + pad_s
    # heads ahead of positions, once: every chunk below is a view whose
    # (B, H) batch flattens without a copy
    q = (q * q_scale(dh, q.dtype)).transpose(1, 2).contiguous()
    k = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    neg_inf = float("-inf")

    outs = []
    for i in range(t // cq):
        qi, qpi = q[:, :, i * cq:(i + 1) * cq], qpos[i * cq:(i + 1) * cq]
        m = torch.full((b, h, cq), neg_inf, device=dev)
        se = torch.zeros((b, h, cq), device=dev)
        acc = torch.zeros((b, h, cq, dh), device=dev)
        for j in range(s // ck):
            sl = slice(j * ck, (j + 1) * ck)
            ki, vi, kpi = k[:, :, sl], v[:, :, sl], kpos[sl]
            sc = matmul_f32(qi, ki.mT)                      # [B,H,cq,ck]
            causal = qpi[:, None] >= kpi[None, :]
            sc = sc.masked_fill(~causal, neg_inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sc - m_safe[..., None]).to(vi.dtype)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            se = se * corr + p.sum(dim=-1, dtype=torch.float32).to(
                p.dtype).float()
            acc = acc * corr[..., None] + matmul_f32(p, vi)
            m = m_new
        se = torch.clamp(se, min=1e-30)
        outs.append(acc / se[..., None])
    out = torch.cat(outs, dim=2).transpose(1, 2)
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

    Under an active mesh the caches are this rank's blocks of a cache
    sequence-sharded over the tensor-parallel axis (split-KV,
    :func:`_attention_decode_split`).
    """
    cur_len = int(cur_len)
    if sl.current_mesh() is not None:
        tp, dp = sl._live_axes(TP), sl._live_axes(DP)
        dpa, tpa = (dp if dp else None), (tp[0] if tp else None)
        kv = P(dpa, tpa, None, None)
        fn = sl.maybe_shard_map(
            lambda *a: _attention_decode_split(*a, cur_len, window, tp),
            in_specs=(P(dpa, None, None), kv, kv, P(dpa, None, None),
                      P(dpa, None, None)),
            out_specs=(P(dpa, None, None), kv, kv))
        return fn(q, k_cache, v_cache, k_new, v_new)
    slot = cur_len if window is None else cur_len % window
    if cur_len < 0 or slot >= k_cache.shape[1]:
        raise ValueError(f"attention_decode: slot {slot} is outside the "
                         f"cache of {k_cache.shape[1]} positions")
    kv_len = cur_len + 1 if window is None else min(cur_len, window - 1) + 1
    k_cache[:, slot] = k_new
    v_cache[:, slot] = v_new
    out = flash_decode(q, k_cache, v_cache, kv_len)
    return out.to(v_cache.dtype), k_cache, v_cache


def _attention_decode_split(q, kc, vc, kn, vn, cur: int,
                            window: Optional[int], tp):
    """The JAX module's mapped decode body on this rank's cache block
    ``[B, S_l, Kh, dh]`` (global slots ``axis_index * S_l + j``): the
    new K/V goes, in place, to the rank that owns the slot; each rank
    scores its valid slots, the ranks agree on the max (``pmax``) and
    sum the exponentiated numerators and denominators (``psum``, the
    denominator clamped at 1e-30)."""
    b, s_l, kh, dh = kc.shape
    g = q.shape[1] // kh
    slot = cur if window is None else cur % window
    if cur < 0 or slot >= s_l * sl.axis_size(tp):
        raise ValueError(f"attention_decode: slot {slot} is outside the "
                         f"cache of {s_l * sl.axis_size(tp)} positions")
    offset = sl.axis_index(tp) * s_l
    if offset <= slot < offset + s_l:
        kc[:, slot - offset] = kn
        vc[:, slot - offset] = vn
    gpos = offset + torch.arange(s_l, device=kc.device)
    valid = gpos <= (cur if window is None else min(cur, window - 1))
    qg = q.reshape(b, 1, kh, g, dh) * q_scale(dh, q.dtype)
    sc = _gqa_scores(qg, kc)[..., 0, :]                      # [B,Kh,G,S_l]
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sl.pmax(sc.amax(dim=-1), tp)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(sc - m[..., None])
    num = sl.psum(torch.einsum("bkgs,bskd->bkgd", p, vc.float()), tp)
    den = torch.clamp(sl.psum(p.sum(dim=-1), tp), min=1e-30)
    out = (num / den[..., None]).reshape(b, kh * g, dh)
    return out.to(vc.dtype), kc, vc


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    """x: [..., D]; wg/wu: [D, F]; wd: [F, D].  ``silu`` is spelled
    ``h * (1 / (1 + exp(-h)))``, one rounding per operation: XLA's
    expansion of ``jax.nn.silu``, so bf16 results keep its bits.

    Tensor-parallel, wg/wu are this rank's column blocks and wd its row
    block: x comes in through :func:`column_in` and the rank's partial
    output goes out through :func:`row_out` (the JAX module's
    ``sl.shard(h, DP, "seq", "mlp")`` is that layout)."""
    return (_silu(x @ wg) * (x @ wu)) @ wd


def column_in(x: torch.Tensor, tp, sp) -> torch.Tensor:
    """The residual stream's ``x`` [B, S, D] made whole for a product
    sharded over the tensor-parallel axes ``tp``: gathered along the
    sequence from its blocks over ``sp`` (sequence parallelism), else
    entering the sharded work (:func:`shardlib.enter`).  Either way the
    ranks' partial cotangents are summed in the backward."""
    if sp:
        return sl.all_gather(x, sp, axis=1)
    return sl.enter(x, tp)


def row_out(y: torch.Tensor, tp, sp) -> torch.Tensor:
    """A row-parallel product's partial ``y`` [B, S, D] (this rank's
    heads or columns) summed over ``tp``: back to the rank's sequence
    block under sequence parallelism (``psum_scatter``), else whole on
    every rank (``psum``)."""
    if sp:
        return sl.psum_scatter(y, tp, 1)
    return sl.psum(y, tp)


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
    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)   # [T, E]
    return _route(probs, cfg)


def _route(probs: torch.Tensor, cfg: MoEConfig,
           p_mean: Optional[torch.Tensor] = None) -> MoERoute:
    """:func:`moe_route` from the router's probabilities [T, E];
    ``p_mean``, their mean over the T tokens, when the caller sums it
    across ranks (the sequence-parallel block)."""
    t = probs.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    gate, eid = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # a token's choices in expert order: the order JAX's scatter-add of
    # the combine meets them in (its updates are sorted by expert)
    eid, perm = torch.sort(eid, dim=-1)
    gate = torch.gather(gate, -1, perm)
    fe = eid.reshape(-1)
    counts = torch.zeros(e, dtype=fe.dtype, device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe))
    if p_mean is None:
        p_mean = probs.mean(dim=0)
    aux = (cfg.router_aux_coef * e) * torch.sum(
        p_mean * (counts.float() / (t * k)))
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
              wu: torch.Tensor, wd: torch.Tensor, cfg: MoEConfig, *,
              seq_sharded: bool = False):
    """Sort-based top-k MoE.  x: [B, S, D]; router_w: [D, E]; wg/wu:
    [E, D, F]; wd: [E, F, D].  Returns (y [B, S, D] in x's dtype, aux
    0-d f32).

    Under an active mesh the experts are sharded over the
    tensor-parallel axis (the JAX block's expert-parallel branch): the
    arguments are this rank's blocks (x over the data axes, ``E / |tp|``
    experts), every rank routes its tokens over all E experts, keeps
    the choices that fall in its expert range within capacity, and the
    ranks' partial outputs are summed (``psum`` over tp); ``aux`` is
    averaged over the data axes.  Each data shard routes its own
    tokens, its capacity counted from them, as JAX's mapped block does.

    ``seq_sharded``: x is this rank's block of the sequence, split over
    the tensor-parallel axis (sequence parallelism, the LM's training
    and prefill): the router runs on the rank's tokens, the
    probabilities and the tokens are gathered for the routing and the
    dispatch, and the output comes back as the rank's sequence block
    (``psum_scatter``).  Every gradient then crosses a collective whose
    backward sums the ranks' parts; the router's, partial over the
    rank's tokens, is summed by the train step.  Without it (x whole on
    every rank, as a decode step gives it) the block serves only:
    training it over more than one tensor-parallel rank is refused, as
    no rule set of the JAX package trains it so.

    Each expert runs its SwiGLU over a ``[cap, D]`` buffer of its
    tokens (zero rows where it has fewer).  The combine is
    deterministic and in JAX's order: a token's k outputs, each times
    its gate rounded to x's dtype, are added left to right in ascending
    expert order onto zeros, rounding after each add, as XLA's
    scatter-add does; no atomics, so bf16 bits repeat run to run."""
    if sl.current_mesh() is None:
        return _moe_experts(x, router_w, wg, wu, wd, cfg, 0)
    tp, dp = sl._live_axes(TP), sl._live_axes(DP)
    dpa, tpa = (dp if dp else None), (tp[0] if tp else None)

    def inner(x, router_w, wg, wu, wd):
        if wg.shape[0] * sl.axis_size(tp) != cfg.n_experts:
            raise ValueError(f"moe_block: {wg.shape[0]} local experts on "
                             f"{sl.axis_size(tp)} ranks for "
                             f"{cfg.n_experts}")
        e_lo = sl.axis_index(tp) * wg.shape[0]
        if seq_sharded:
            y, aux = _moe_seq_sharded(x, router_w, wg, wu, wd, cfg, e_lo,
                                      tp)
        else:
            if (torch.is_grad_enabled() and sl.axis_size(tp) > 1
                    and any(a.requires_grad for a in (x, router_w, wg))):
                raise NotImplementedError(
                    "moe_block: training the expert-parallel block needs "
                    "seq_sharded=True (sequence parallelism)")
            y, aux = _moe_experts(x, router_w, wg, wu, wd, cfg, e_lo)
            y = sl.psum(y, tp)
        return y, sl.psum(aux, dp) / sl.axis_size(dp)

    ew = P(tpa, None, None)
    xs = P(dpa, tpa if seq_sharded else None, None)
    return sl.maybe_shard_map(
        inner, in_specs=(xs, P(None, None), ew, ew, ew),
        out_specs=(xs, P()))(x, router_w, wg, wu, wd)


def _moe_seq_sharded(x, router_w, wg, wu, wd, cfg: MoEConfig, e_lo: int,
                     tp):
    """The expert-parallel body on this rank's sequence block ``x``
    [B, S_l, D]: (its output block [B, S_l, D], the data shard's aux)."""
    b, s_l, d = x.shape
    e = cfg.n_experts
    probs_l = torch.softmax(x.reshape(b * s_l, d).float()
                            @ router_w.float(), dim=-1)        # [T_l, E]
    probs = sl.all_gather(probs_l.reshape(b, s_l, e), tp, axis=1)
    xt = sl.all_gather(x, tp, axis=1)
    s = xt.shape[1]
    # the mean over the data shard's tokens: summed over the ranks (on
    # one rank, the unsharded block's mean)
    p_mean = (sl.psum(probs_l.sum(dim=0), tp) / (b * s)
              if sl.axis_size(tp) > 1 else None)
    r = _route(probs.reshape(b * s, e), cfg, p_mean)
    y = _experts(xt.reshape(b * s, d), r, wg, wu, wd, e_lo)
    return sl.psum_scatter(y.reshape(b, s, d), tp, 1), r.aux


def _moe_experts(x, router_w, wg, wu, wd, cfg: MoEConfig, e_lo: int):
    """The MoE body over experts ``[e_lo, e_lo + e_l)`` (``e_l`` the
    stacks' leading dim; all E at ``e_lo`` 0): every token is routed over
    all E experts, and only its choices in that range and within
    capacity are dispatched and combined."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    r = moe_route(xt, router_w, cfg)
    return _experts(xt, r, wg, wu, wd, e_lo).reshape(b, s, d), r.aux


def _experts(xt, r: MoERoute, wg, wu, wd, e_lo: int) -> torch.Tensor:
    """Dispatch, the experts ``[e_lo, e_lo + e_l)`` and the combine of
    the tokens ``xt`` [T, D] routed by ``r``: [T, D] in xt's dtype."""
    t, d = xt.shape
    k = r.expert.shape[1]
    e_l = wg.shape[0]
    local = r.keep & (r.expert >= e_lo) & (r.expert < e_lo + e_l)
    slot = torch.where(local, r.slot - e_lo * r.cap, e_l * r.cap)
    # each choice's token row into its slot of a zero buffer; the drops
    # all land on the scrap row e_l * cap, cut off below.  (Put, not a
    # gather from a zero row: the gather's backward would add every
    # empty slot's gradient into that one row, serially.)
    rows = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xt.new_zeros(e_l * r.cap + 1, d).index_put(
        (slot.reshape(-1),), rows)
    hb = buf[:e_l * r.cap].reshape(e_l, r.cap, d)
    h = _silu(torch.bmm(hb, wg)) * torch.bmm(hb, wu)
    ob = torch.bmm(h, wd).reshape(e_l * r.cap, d)
    ob = torch.cat([ob, ob.new_zeros(1, d)])
    w = torch.where(local, r.gate, 0.0).to(ob.dtype)
    # a gather whose backward is an index_add_ (the drops' gradients
    # all meet on the scrap row; atomics take them at once)
    contrib = torch.index_select(ob, 0, slot.reshape(-1)).reshape(
        t, k, d) * w[..., None]                              # [T, k, D]
    y = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def moe_block_paramspec(cfg: MoEConfig, d_model: int):
    """Logical axes of the MoE block's parameters."""
    return dict(router=("embed", "expert"),
                wg=("expert", "embed", "expert_mlp"),
                wu=("expert", "embed", "expert_mlp"),
                wd=("expert", "expert_mlp", "embed"))
