"""Decoder-only LM of the port: parameters, the training forward and
loss, prefill and decode (serving).

The JAX package's ``models/transformer.py`` on one device, for all five
LM archs of its registry: dense GQA (glm4-9b, command-r-35b), gemma3's
5:1 local:global sliding window (``sliding_window`` with
``local_global_period=6``; local layers keep rolling caches of
``window`` slots) and top-k MoE (granite-moe, qwen3-moe:
``moe=MoEConfig(...)``, whose aux loss ``forward`` returns).
Parameters keep its pytree layout: ``embed``
[V, D], ``ln_f`` [D], optional ``head`` [D, V], and ``layers``, a list
per cycle position of dicts of ``[n_cycles, ...]`` stacks, so
``models/convert.py`` carries JAX weights across unchanged.  Both
serving functions round where the JAX ones do: every parameter
(the norm scales included) is cast to ``compute_dtype`` each call, the
embedding is scaled by ``sqrt(d_model)`` in that dtype, and the logits
are a ``compute_dtype`` product widened to f32 afterwards.

Decode attention runs the hand-written ``flash_decode`` kernel (through
``layers.attention_decode``) and updates the caches in place.  Training
(:func:`forward`, :func:`loss_fn`) follows the JAX functions: each cycle
of layers is recomputed in the backward pass when ``cfg.remat`` is set
(``torch.utils.checkpoint``, as the JAX scan body is ``jax.checkpoint``'d),
and so is each chunk of the cross-entropy.  The ``block_outs`` remat
policy and ``attn_opt`` come later (``ROADMAP.md`` queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .common import dense_init
from .layers import (MoEConfig, attention_causal, attention_decode,
                     attention_window, moe_block, rms_norm, rope_cos_sin,
                     rotate, swiglu)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # defaults to d_model // n_heads
    rope_theta: float = 1e4
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None    # window for *local* layers
    local_global_period: int = 1            # 6 => 5 local + 1 global (gemma3)
    tie_embeddings: bool = True
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True                      # recompute each cycle in backward
    attn_chunk: int = 1024
    loss_chunk: int = 2048                  # tokens a cross-entropy chunk
    subquadratic: bool = False              # True iff long-context decode ok
    # "none" saves only cycle boundaries; the JAX package's "block_outs"
    # (save each block's output) is not ported (ROADMAP.md queue 1).
    remat_policy: str = "none"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_cycles(self) -> int:
        if self.n_layers % self.local_global_period:
            raise ValueError(f"{self.n_layers} layers do not split into "
                             f"cycles of {self.local_global_period}")
        return self.n_layers // self.local_global_period

    def layer_is_local(self, pos_in_cycle: int) -> bool:
        """gemma3 pattern: positions 0..p-2 local, p-1 global."""
        if self.sliding_window is None or self.local_global_period == 1:
            return self.sliding_window is not None
        return pos_in_cycle != self.local_global_period - 1

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.moe is None:
            mlp = 3 * d * self.d_ff
        else:
            mlp = (self.moe.n_experts * 3 * d * self.moe.d_ff
                   + d * self.moe.n_experts)
        per_layer = attn + mlp + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        experts = self.n_layers * 3 * d * m.d_ff
        return self.param_count() - experts * m.n_experts + experts * m.top_k


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    shapes = {"ln1": (d,), "ln2": (d,),
              "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    if cfg.moe is None:
        shapes.update(wg=(d, cfg.d_ff), wu=(d, cfg.d_ff), wd=(cfg.d_ff, d))
    else:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff
        shapes.update(router=(d, e), wg=(e, d, f), wu=(e, d, f),
                      wd=(e, f, d))
    return shapes


def _fan_in_axis(cfg: TransformerConfig, name: str) -> int:
    """The expert stacks draw with fan-in on axis 1, as in JAX."""
    return 1 if cfg.moe is not None and name in ("wg", "wu", "wd") else 0


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters with the JAX ``init_params`` law (normal x
    fan_in^-0.5 for matrices, the experts' fan-in on their axis 1, zeros
    for the norm scales), drawn from ``generator`` on ``device``
    (default ``cuda``; the generator must
    live there, default seed 0) and stored in ``dtype`` (default
    ``cfg.param_dtype``).  Each layer is drawn in f32 and cast into its
    slot of the stack, so the full model is made on the card without an
    f32 copy of it."""
    device = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    gen = (torch.Generator(device=device).manual_seed(0)
           if generator is None else generator)
    shapes = _layer_shapes(cfg)
    per_pos: List[Dict[str, torch.Tensor]] = []
    for _ in range(cfg.local_global_period):
        stack = {}
        for name, shp in shapes.items():
            if name.startswith("ln"):
                stack[name] = torch.zeros((cfg.n_cycles,) + shp, dtype=dt,
                                          device=device)
                continue
            stack[name] = torch.empty((cfg.n_cycles,) + shp, dtype=dt,
                                      device=device)
            for c in range(cfg.n_cycles):
                stack[name][c] = dense_init(gen, shp,
                                            _fan_in_axis(cfg, name),
                                            dtype=dt, device=device)
        per_pos.append(stack)
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype=dt,
                            device=device),
        "ln_f": torch.zeros(cfg.d_model, dtype=dt, device=device),
        "layers": per_pos,
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dt,
                                    device=device)
    return params


def lm_head_weight(params, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def make_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None
               ) -> List[Dict[str, torch.Tensor]]:
    """Cache list: per cycle position, K and V of [n_cycles, B, S*, Kh,
    hd], zero-filled on ``device`` (default ``cuda``).  S* is
    ``seq_len``, or ``min(window, seq_len)`` for a local position's
    rolling cache (what lets gemma3's long_500k fit)."""
    device = resolve_device(device)
    caches = []
    for pos in range(cfg.local_global_period):
        s = (min(cfg.sliding_window, seq_len) if cfg.layer_is_local(pos)
             else seq_len)
        shp = (cfg.n_cycles, batch, s, cfg.n_kv_heads, cfg.hd)
        caches.append({"k": torch.zeros(shp, dtype=dtype, device=device),
                       "v": torch.zeros(shp, dtype=dtype, device=device)})
    return caches


# ---------------------------------------------------------------------------
# Training: forward + chunked loss
# ---------------------------------------------------------------------------

def _attend(q, k, v, cfg: TransformerConfig, local: bool, positions):
    """Prefill and training attention: the window schedule on a local
    layer, the causal one elsewhere."""
    if local:
        return attention_window(q, k, v, cfg.sliding_window,
                                q_positions=positions)
    return attention_causal(q, k, v, chunk=cfg.attn_chunk,
                            q_positions=positions, kv_positions=positions)


def _mlp(h, lp, cfg: TransformerConfig):
    """(the MLP's output, its aux loss or None): SwiGLU, or the MoE block
    on ``h`` [B, S, D]."""
    if cfg.moe is None:
        return swiglu(h, lp["wg"], lp["wu"], lp["wd"]), None
    return moe_block(h, lp["router"], lp["wg"], lp["wu"], lp["wd"], cfg.moe)


def _attn_train(x, lp, cfg: TransformerConfig, local: bool, positions, cos,
                sin):
    b, s, _ = x.shape
    hd = cfg.hd
    h = rms_norm(x, lp["ln1"])
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    k = rotate(k, cos, sin)
    q = rotate(q, cos, sin)
    o = _attend(q, k, v, cfg, local, positions)
    return o.reshape(b, s, cfg.n_heads * hd) @ lp["wo"]


def _cycle_train(x, aux, cycle, cfg: TransformerConfig, positions, cos,
                 sin):
    """One cycle of layers (``cycle``: a dict of one layer's parameters a
    position), each cast to ``compute_dtype`` here so that a recomputed
    cycle keeps no cast copy alive.  Returns (x, aux + each MoE layer's
    aux, added in JAX's order)."""
    cd = cfg.compute_dtype
    for p_i, layer in enumerate(cycle):
        lp = {name: a.to(cd) for name, a in layer.items()}
        x = x + _attn_train(x, lp, cfg, cfg.layer_is_local(p_i), positions,
                            cos, sin)
        dx, a = _mlp(rms_norm(x, lp["ln2"]), lp, cfg)
        x = x + dx
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None):
    """tokens [B, S] -> (final hidden states [B, S, D] in
    ``compute_dtype``, aux loss: 0-d f32, the sum of the MoE layers'
    aux losses, zero for a dense arch).  ``params["layers"]`` holds
    ``[n_cycles, ...]`` stacks, or lists of per-cycle tensors (what the
    train step passes, so that each cycle's gradient lands in its own
    slot of one buffer).

    Rounding follows the JAX forward: the whole embedding is cast to
    ``compute_dtype`` before the gather (its gradient is summed in that
    dtype, as XLA's scatter-add is), the layers and ``ln_f`` are cast to
    it, and RoPE and the norms compute in f32."""
    if cfg.remat_policy != "none":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} comes with the optimized "
            "LM variant (ROADMAP.md queue 1)")
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cd = cfg.compute_dtype
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=cd)).item()
    x = params["embed"].to(cd)[tokens] * scale
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(cfg.n_cycles):
        cycle = [{name: a[c] for name, a in pos.items()}
                 for pos in params["layers"]]
        if cfg.remat:
            x, aux = checkpoint(_cycle_train, x, aux, cycle, cfg, positions,
                                cos, sin, use_reentrant=False)
        else:
            x, aux = _cycle_train(x, aux, cycle, cfg, positions, cos, sin)
    x = rms_norm(x, params["ln_f"].to(cd))
    return x, aux


def _chunk_loss(xc: torch.Tensor, yc: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """Summed cross-entropy of one chunk: logits a ``compute_dtype``
    product widened to f32."""
    logits = (xc @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return (lse - picked).sum()


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (+ the aux loss), with the logits
    made ``loss_chunk`` positions at a time and each chunk recomputed in
    the backward pass (the JAX ``jax.checkpoint(chunk_loss)``), so that
    at most one chunk's logits are alive.  S must be a multiple of the
    chunk, as the JAX reshape requires."""
    x, aux = forward(params, tokens, cfg)
    b, s, _ = x.shape
    w = lm_head_weight(params, cfg).to(cfg.compute_dtype)
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"loss_fn: sequence length {s} is not a multiple "
                         f"of loss_chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        tot = tot + checkpoint(_chunk_loss, x[:, sl], labels[:, sl], w,
                               use_reentrant=False)
    return tot / (b * s) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: TransformerConfig
           ) -> torch.Tensor:
    """Embedding rows in ``compute_dtype`` times ``sqrt(d_model)`` taken
    in that dtype (a host scalar: no copy to the card, no sync)."""
    cd = cfg.compute_dtype
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=cd)).item()
    return params["embed"][tokens].to(cd) * scale


def _layers(params, cfg: TransformerConfig):
    """(cycle, position in cycle, that layer's params cast to
    ``compute_dtype``) in the order the JAX scan runs them."""
    cd = cfg.compute_dtype
    for c in range(cfg.n_cycles):
        for p_i in range(cfg.local_global_period):
            yield c, p_i, {name: a[c].to(cd)
                           for name, a in params["layers"][p_i].items()}


def decode_step(params, caches, tokens: torch.Tensor, cur_len: int,
                cfg: TransformerConfig):
    """One decode step: tokens [B] int, cur_len int -> (logits [B, V] f32,
    caches).  The new token sits at position ``cur_len``; entries
    [0, cur_len) are valid (a local layer's rolling cache holds the last
    ``window`` of them).  The caches are updated in place and returned.
    An MoE layer routes the step's B tokens as one batch (JAX's
    ``h2[:, None, :]``, so its capacity is JAX's)."""
    b = tokens.shape[0]
    hd = cfg.hd
    x = _embed(params, tokens, cfg)                       # [B, D]
    pos = torch.full((1,), int(cur_len), dtype=torch.int32,
                     device=tokens.device)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)     # [1, 1, hd/2]
    for c, p_i, lp in _layers(params, cfg):
        h = rms_norm(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(b, cfg.n_heads, hd)
        kn = (h @ lp["wk"]).reshape(b, cfg.n_kv_heads, hd)
        vn = (h @ lp["wv"]).reshape(b, cfg.n_kv_heads, hd)
        q = rotate(q[:, None], cos, sin)[:, 0]
        kn = rotate(kn[:, None], cos, sin)[:, 0]
        window = cfg.sliding_window if cfg.layer_is_local(p_i) else None
        o, _, _ = attention_decode(q, caches[p_i]["k"][c],
                                   caches[p_i]["v"][c], kn, vn, cur_len,
                                   window=window)
        x = x + (o.reshape(b, cfg.n_heads * hd) @ lp["wo"])
        h2 = rms_norm(x, lp["ln2"])
        x = x + _mlp(h2[:, None, :], lp, cfg)[0][:, 0]
    cd = cfg.compute_dtype
    x = rms_norm(x, params["ln_f"].to(cd))
    logits = (x @ lm_head_weight(params, cfg).to(cd)).float()
    return logits, caches


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B, S] -> (last-position logits [B, V] f32, caches filled
    [0, S) in ``compute_dtype``, laid out as :func:`make_cache`'s; a
    local layer keeps its last ``min(window, S)`` keys, at slots
    ``0..w-1`` as JAX does.  Decode's slot ``cur % window`` continues
    that ring only when S is at most the window or a multiple of it;
    after another S, JAX's decode evicts a key still inside the window,
    and the port, held to JAX, does the same."""
    b, s = tokens.shape
    hd = cfg.hd
    cd = cfg.compute_dtype
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    x = _embed(params, tokens, cfg)
    caches = make_cache(cfg, b, s, dtype=cd, device=tokens.device)
    for c, p_i, lp in _layers(params, cfg):
        h = rms_norm(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
        o = _attend(q, k, v, cfg, cfg.layer_is_local(p_i), positions)
        w = caches[p_i]["k"].shape[2]
        caches[p_i]["k"][c] = k[:, s - w:]
        caches[p_i]["v"][c] = v[:, s - w:]
        x = x + (o.reshape(b, s, cfg.n_heads * hd) @ lp["wo"])
        h2 = rms_norm(x, lp["ln2"])
        x = x + _mlp(h2, lp, cfg)[0]
    x = rms_norm(x[:, -1], params["ln_f"].to(cd))
    logits = (x @ lm_head_weight(params, cfg).to(cd)).float()
    return logits, caches
