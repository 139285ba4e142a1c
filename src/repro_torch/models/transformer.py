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
and so is each chunk of the cross-entropy.  The optimized variant's two
settings: ``attn_opt`` trains a global layer with
``layers.attention_causal_opt`` (prefill keeps ``attention_causal``, as
JAX's does), and ``remat_policy="block_outs"`` recomputes each attention
and each MLP block on its own in place of the whole cycle.

Under an active mesh (``shardlib.axis_rules`` with ``rules_train_lm`` or
``rules_serve_lm``) every function runs on this rank's blocks, laid out
by :func:`param_shardings` and :func:`cache_shardings`, and places by
hand the collectives GSPMD places in the JAX package (Megatron's
layout, :class:`_Layout`): FSDP gathers each weight block over the data
axes just before its use (its backward sums the gradient back to the
block); ``wq``/``wk``/``wv``/``wg``/``wu``, the head and the vocab rows
of ``embed`` are column blocks over the tensor-parallel axis, ``wo`` and
``wd`` row blocks whose partial outputs are summed (``layers.row_out``);
under sequence parallelism the residual stream and the norms hold the
rank's block of the sequence ``[B, S / |model|, D]``, and a block
gathers the sequence before its column-parallel product, so attention
runs over the whole sequence for the rank's heads.  The embedding looks
up the rank's vocab rows (zeros elsewhere) and the ranks sum; the loss
takes its log-sum-exp and the label's logit across the vocab blocks.
KV heads that do not split over the tensor-parallel axis come from
``wk``/``wv`` gathered whole, each rank taking the KV heads its query
heads read.  The loss is the whole batch's on every rank: the
gradients each rank holds are then its blocks' parts, which
``launch/steps.py`` sums (``shardlib.reduce_grads``) over the axes a
leaf's uses are partial on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import shardlib as sl
from ..device import resolve_device
from . import init
from .common import dense_init
from .layers import (MoEConfig, attention_causal, attention_causal_opt,
                     attention_decode, attention_window, column_in,
                     moe_block, rms_norm, row_out, rope_cos_sin, rotate,
                     swiglu)


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
    remat: bool = True                      # recompute in backward
    attn_chunk: int = 1024
    loss_chunk: int = 2048                  # tokens a cross-entropy chunk
    subquadratic: bool = False              # True iff long-context decode ok
    # the optimized variant's training attention on global layers:
    # layers.attention_causal_opt (flat GQA heads, bf16 probabilities)
    attn_opt: bool = False
    # "none" recomputes each cycle of layers in backward; "block_outs"
    # each attention and each MLP block on its own, saving the residual
    # stream before each (the torch form of JAX's saved block outputs)
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
                dtype: Optional[torch.dtype] = None, shardings=None,
                draw: bool = True) -> Dict[str, Any]:
    """Random parameters with the JAX ``init_params`` law (normal x
    fan_in^-0.5 for matrices, the experts' fan-in on their axis 1, zeros
    for the norm scales) on ``device`` (default ``cuda``), stored in
    ``dtype`` (default ``cfg.param_dtype``).

    Without a ``generator``: the keyed draw (``models/init.py``), each
    leaf keyed by its path in the tree (``layers/0/wq``), tiled by its
    logical axes (:func:`param_shardings`; a stack per cycle), and this
    rank's block under its ``NamedSharding`` in ``shardings`` (a tree
    like the parameters'; None: whole leaves).  ``draw=False`` leaves
    the blocks uninitialised (for a restore, or fake tensors).

    With a ``generator`` (it must live on ``device``): the whole model
    drawn from it in sequence (:func:`draw_sequential_`), each layer
    drawn in f32 and cast into its slot of the stack, so the full model
    is made on the card without an f32 copy of it."""
    device = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    if generator is not None:
        return draw_sequential_(_empty_params(cfg, dt, device), cfg,
                                generator)
    axes = param_shardings(cfg)

    def leaf(path, shape, ax, in_axis=None):
        sharding = shardings
        for key in path.split("/"):
            if sharding is not None:
                sharding = sharding[int(key) if key.isdigit() else key]
        if in_axis is None:
            return init.keyed(path, shape, ax, dtype=dt, device=device,
                              sharding=sharding, draw=draw)
        return dense_init(None, shape, in_axis, dt, device, path=path,
                          axes=ax, sharding=sharding, draw=draw)
    per_pos: List[Dict[str, torch.Tensor]] = []
    for pos in range(cfg.local_global_period):
        stack = {}
        for name, shp in _layer_shapes(cfg).items():
            stack[name] = leaf(
                f"layers/{pos}/{name}", (cfg.n_cycles,) + shp,
                axes["layers"][pos][name], None if name.startswith("ln")
                else 1 + _fan_in_axis(cfg, name))
        per_pos.append(stack)
    params = {
        "embed": leaf("embed", (cfg.vocab, cfg.d_model), axes["embed"], 0),
        "ln_f": leaf("ln_f", (cfg.d_model,), axes["ln_f"]),
        "layers": per_pos,
    }
    if not cfg.tie_embeddings:
        params["head"] = leaf("head", (cfg.d_model, cfg.vocab),
                              axes["head"], 0)
    return params


def _empty_params(cfg: TransformerConfig, dtype: torch.dtype, device
                  ) -> Dict[str, Any]:
    """Whole parameters, uninitialised."""
    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)
    params = {"embed": empty(cfg.vocab, cfg.d_model),
              "ln_f": empty(cfg.d_model),
              "layers": [{name: empty(cfg.n_cycles, *shp)
                          for name, shp in _layer_shapes(cfg).items()}
                         for _ in range(cfg.local_global_period)]}
    if not cfg.tie_embeddings:
        params["head"] = empty(cfg.d_model, cfg.vocab)
    return params


@torch.no_grad()
def draw_sequential_(params: Dict[str, Any], cfg: TransformerConfig,
                     generator: torch.Generator) -> Dict[str, Any]:
    """Whole parameters ``params`` rewritten in place, and returned, by
    the sequential law of :func:`init_params` with a ``generator``: each
    cycle position's stacks in turn (every matrix cycle by cycle; the
    norm scales zeroed), then ``embed``, then ``head``, each matrix
    drawn whole in f32, scaled and cast into its place.  A cell's
    weights (the keyed draw) become the ones a sequential draw from the
    same generator state makes, holding no more than one matrix in f32
    beside them."""
    def draw(dst, in_axis):
        w = torch.randn(tuple(dst.shape), generator=generator,
                        device=dst.device, dtype=torch.float32)
        dst.copy_(w.mul_(init.fan_in_scale(dst.shape, in_axis)))
    for stack in params["layers"]:
        for name in _layer_shapes(cfg):
            if name.startswith("ln"):
                stack[name].zero_()
                continue
            for c in range(cfg.n_cycles):
                draw(stack[name][c], _fan_in_axis(cfg, name))
    for name in ("embed", "head"):
        if name in params:
            draw(params[name], 0)
    params["ln_f"].zero_()
    return params


def param_shardings(cfg: TransformerConfig):
    """Logical axes per parameter (FSDP on input dims, TP on output
    dims), in the parameters' tree: the layout ``Cell.in_shardings``
    records for a whole-model sharded step."""
    attn = dict(ln1=(None,), ln2=(None,),
                wq=("fsdp", "heads"), wk=("fsdp", "kv_heads"),
                wv=("fsdp", "kv_heads"), wo=("heads", "fsdp"))
    if cfg.moe is None:
        attn.update(wg=("fsdp", "mlp"), wu=("fsdp", "mlp"),
                    wd=("mlp", "fsdp"))
    else:
        attn.update(router=(None, None),
                    wg=("expert", "fsdp", None), wu=("expert", "fsdp", None),
                    wd=("expert", None, "fsdp"))
    layer = {k: ("layer_stack",) + v for k, v in attn.items()}
    tree = {"embed": ("vocab", "fsdp"), "ln_f": (None,),
            "layers": [dict(layer) for _ in range(cfg.local_global_period)]}
    if not cfg.tie_embeddings:
        tree["head"] = ("fsdp", "vocab")
    return tree


def cache_shardings(cfg: TransformerConfig):
    """Logical axes of :func:`make_cache`'s caches (sequence-sharded:
    split-KV decode)."""
    ax = ("layer_stack", "batch", "kv_seq", None, None)
    return [{"k": ax, "v": ax} for _ in range(cfg.local_global_period)]


def lm_head_weight(params, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def make_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               shardings=None) -> List[Dict[str, torch.Tensor]]:
    """Cache list: per cycle position, K and V of [n_cycles, B, S*, Kh,
    hd], zero-filled on ``device`` (default ``cuda``).  S* is
    ``seq_len``, or ``min(window, seq_len)`` for a local position's
    rolling cache (what lets gemma3's long_500k fit).  With
    ``shardings`` (a tree like :func:`cache_shardings`'s, of
    ``NamedSharding``) each is this rank's block, made at block size."""
    device = resolve_device(device)
    caches = []
    for pos in range(cfg.local_global_period):
        s = (min(cfg.sliding_window, seq_len) if cfg.layer_is_local(pos)
             else seq_len)
        shp = (cfg.n_cycles, batch, s, cfg.n_kv_heads, cfg.hd)
        caches.append({
            n: torch.zeros(tuple(b.stop - b.start for b in init.block_slices(
                shp, None if shardings is None else shardings[pos][n])),
                dtype=dtype, device=device)
            for n in ("k", "v")})
    return caches


# ---------------------------------------------------------------------------
# The layout across ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a call's tensors live under the current rules: the batch's
    data axes ``dp``, the tensor-parallel axes ``tp`` (heads, kv_heads,
    mlp, expert and vocab, which the LM rule sets all bind to
    ``model``), this rank's size and index over them, and ``sp``, the
    residual stream's sequence axes (``tp`` or ()).  All empty without
    a mesh."""
    dp: tuple = ()
    tp: tuple = ()
    sp: tuple = ()
    n_tp: int = 1
    i_tp: int = 0


def _layout(cfg: TransformerConfig, seq: bool = True) -> _Layout:
    """The current rules' layout for ``cfg`` (``seq=False``: a decode
    step, which has no sequence to split).  Refuses a layout the layer
    code cannot run: heads that do not split over the tensor-parallel
    ranks, or query heads whose KV heads no rank can take whole."""
    if sl.current_mesh() is None:
        return _Layout()
    tp = sl._live_axes("heads")
    for name in ("kv_heads", "mlp", "vocab", "expert"):
        ax = sl._live_axes(name)
        if ax and ax != tp:
            raise ValueError(f"{cfg.name}: {name!r} is bound to {ax}, the "
                             f"heads to {tp}; the layer code wants one "
                             "tensor-parallel axis")
    sp = sl._live_axes("seq") if seq else ()
    if sp and sp != tp:
        raise ValueError(f"{cfg.name}: the sequence is split over {sp}, "
                         f"the heads over {tp}; sequence parallelism "
                         "wants the same axes")
    lay = _Layout(sl._live_axes("batch"), tp, sp, sl.axis_size(tp),
                  sl.axis_index(tp))
    _kv_heads(cfg, lay)                     # refuse early
    return lay


def _mesh_text(lay: _Layout) -> str:
    mesh = sl.current_mesh()
    return (f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
            if mesh is not None else "no mesh")


def _kv_heads(cfg: TransformerConfig, lay: _Layout):
    """(query heads this rank holds, its first query head, whether
    ``wk``/``wv`` are gathered whole, the KV heads its query heads read
    as a range of the whole)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h % lay.n_tp:
        raise ValueError(f"{cfg.name}: {h} query heads do not split over "
                         f"the {lay.n_tp} tensor-parallel ranks of the "
                         f"{_mesh_text(lay)}")
    h_l = h // lay.n_tp
    q_lo = lay.i_tp * h_l
    g = h // kv
    if kv % lay.n_tp == 0:                  # the rank's own column block
        return h_l, q_lo, False, (q_lo // g, (q_lo + h_l) // g)
    if not ((h_l % g == 0 and q_lo % g == 0) or g % h_l == 0):
        raise ValueError(f"{cfg.name}: {kv} KV heads do not split over the "
                         f"{lay.n_tp} tensor-parallel ranks of the "
                         f"{_mesh_text(lay)}, and a rank's {h_l} query "
                         f"heads do not read whole groups of {g}")
    return h_l, q_lo, True, (q_lo // g, (q_lo + h_l - 1) // g + 1)


def _weight(a: torch.Tensor, names, cd) -> torch.Tensor:
    """This rank's block ``a`` of a weight with logical axes ``names``,
    cast to ``cd`` and gathered whole along its FSDP dims (the gather's
    backward sums the ranks' gradients back to the block)."""
    a = a.to(cd)
    spec = tuple(sl.logical_to_spec(*names))
    for d, (name, part) in enumerate(zip(names, spec)):
        if name == "fsdp" and part is not None:
            a = sl.all_gather(a, (part,) if isinstance(part, str)
                              else tuple(part), axis=d)
    return a


def _layer_names(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Each layer parameter's logical axes without ``layer_stack``."""
    return {k: v[1:] for k, v in param_shardings(cfg)["layers"][0].items()}


def _cast_layer(layer, names, cfg: TransformerConfig, keys):
    return {k: _weight(layer[k], names[k], cfg.compute_dtype) for k in keys}


def _kv_weights(lp, cfg: TransformerConfig, lay: _Layout, whole: bool):
    """``wk``/``wv`` as this rank uses them: its own column block, the
    columns of the KV heads its query heads read (gathered whole over
    ``tp`` first, when the KV heads do not split), or every KV head
    (``whole``: prefill fills the caches of all of them)."""
    _, _, gather, (lo, hi) = _kv_heads(cfg, lay)
    wk, wv = lp["wk"], lp["wv"]
    if not gather and not whole:
        return wk, wv, (0, hi - lo)
    if gather or (whole and lay.n_tp > 1):
        wk = sl.all_gather(wk, lay.tp, axis=1)
        wv = sl.all_gather(wv, lay.tp, axis=1)
    if whole:
        return wk, wv, (lo, hi)
    cols = slice(lo * cfg.hd, hi * cfg.hd)
    return wk[:, cols], wv[:, cols], (0, hi - lo)


def _embed_rows(table, tokens, scale, lay: _Layout, seq: bool):
    """``table[tokens] * scale`` with ``table`` this rank's vocab rows
    (the rows it does not hold read as zeros, and the ranks sum): the
    rank's sequence block under sequence parallelism (``seq``), else
    the whole on every rank.  A vocab split over one rank is the whole
    vocab, looked up as it is."""
    if lay.n_tp == 1:
        return table[tokens] * scale
    v_l = table.shape[0]
    idx = tokens.long() - lay.i_tp * v_l
    own = (idx >= 0) & (idx < v_l)
    rows = table[idx.clamp(0, v_l - 1)] * scale
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    if seq and lay.sp:
        return sl.psum_scatter(rows, lay.tp, 1)
    return sl.psum(rows, lay.tp)


def _head(params, cfg: TransformerConfig) -> torch.Tensor:
    """The head [D, V / |tp|] in ``compute_dtype``: this rank's vocab
    columns, gathered whole along D."""
    cd = cfg.compute_dtype
    if cfg.tie_embeddings:
        return _weight(params["embed"], ("vocab", "fsdp"), cd).T
    return _weight(params["head"], ("fsdp", "vocab"), cd)


# ---------------------------------------------------------------------------
# Training: forward + chunked loss
# ---------------------------------------------------------------------------

def _attend(q, k, v, cfg: TransformerConfig, local: bool, positions,
            opt: bool = False):
    """Prefill and training attention: the window schedule on a local
    layer, the causal one elsewhere (``opt``: the optimized variant's,
    which training takes under ``cfg.attn_opt``; prefill never does)."""
    if local:
        return attention_window(q, k, v, cfg.sliding_window,
                                q_positions=positions)
    causal = attention_causal_opt if opt else attention_causal
    return causal(q, k, v, chunk=cfg.attn_chunk, q_positions=positions,
                  kv_positions=positions)


def _mlp(h, lp, cfg: TransformerConfig, lay: _Layout):
    """(the MLP's output, its aux loss or None): SwiGLU (column- then
    row-parallel), or the MoE block, on ``h`` [B, S, D] (the rank's
    sequence block under sequence parallelism)."""
    if cfg.moe is None:
        return row_out(swiglu(column_in(h, lay.tp, lay.sp), lp["wg"],
                              lp["wu"], lp["wd"]), lay.tp, lay.sp), None
    return moe_block(h, lp["router"], lp["wg"], lp["wu"], lp["wd"], cfg.moe,
                     seq_sharded=bool(lay.sp))


_ATTN_PARAMS = ("ln1", "wq", "wk", "wv", "wo")


def _attn_block(x, layer, cfg: TransformerConfig, local: bool, positions,
                cos, sin):
    """A layer's attention block on the residual stream ``x``, its
    parameters cast to ``compute_dtype`` (and gathered) here, so that a
    recomputed block keeps no cast copy alive."""
    lay = _layout(cfg)
    lp = _cast_layer(layer, _layer_names(cfg), cfg, _ATTN_PARAMS)
    hd = cfg.hd
    h_l = cfg.n_heads // lay.n_tp
    h = column_in(rms_norm(x, lp["ln1"]), lay.tp, lay.sp)
    b, s, _ = h.shape
    wk, wv, _ = _kv_weights(lp, cfg, lay, whole=False)
    q = (h @ lp["wq"]).reshape(b, s, h_l, hd)
    k = (h @ wk).reshape(b, s, -1, hd)
    v = (h @ wv).reshape(b, s, -1, hd)
    k = rotate(k, cos, sin)
    q = rotate(q, cos, sin)
    o = _attend(q, k, v, cfg, local, positions, opt=cfg.attn_opt)
    return row_out(o.reshape(b, s, h_l * hd) @ lp["wo"], lay.tp, lay.sp)


def _mlp_block(x, layer, cfg: TransformerConfig):
    """A layer's MLP block (its parameters cast here, as in
    :func:`_attn_block`): (the block's output, its aux loss or None)."""
    names = _layer_names(cfg)
    lp = _cast_layer(layer, names, cfg,
                     [k for k in layer if k not in _ATTN_PARAMS])
    lay = _layout(cfg)
    return _mlp(rms_norm(x, lp["ln2"]), lp, cfg, lay)


def _run(fn, *args):
    return fn(*args)


def _run_checkpointed(fn, *args):
    return checkpoint(sl.under_current_rules(fn), *args, use_reentrant=False)


def _cycle_train(x, aux, cycle, cfg: TransformerConfig, positions, cos,
                 sin, run=_run):
    """One cycle of layers (``cycle``: a dict of one layer's parameters a
    position), each block through ``run`` (``_run_checkpointed`` under
    ``block_outs``).  Returns (x, aux + each MoE layer's aux, added in
    JAX's order)."""
    for p_i, layer in enumerate(cycle):
        x = x + run(_attn_block, x, layer, cfg, cfg.layer_is_local(p_i),
                    positions, cos, sin)
        dx, a = run(_mlp_block, x, layer, cfg)
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
    slot of one buffer).  Under sequence parallelism the hidden states
    are this rank's block of the sequence ``[B, S / |model|, D]``.

    Rounding follows the JAX forward: the whole embedding is cast to
    ``compute_dtype`` before the gather (its gradient is summed in that
    dtype, as XLA's scatter-add is), the layers and ``ln_f`` are cast to
    it, and RoPE and the norms compute in f32.  Under ``cfg.remat``
    the backward pass recomputes each cycle (``remat_policy="none"``) or
    each block (``"block_outs"``) once, its collectives with it."""
    if cfg.remat_policy not in ("none", "block_outs"):
        raise ValueError(f"remat_policy must be 'none' or 'block_outs', "
                         f"got {cfg.remat_policy!r}")
    lay = _layout(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cd = cfg.compute_dtype
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=cd)).item()
    x = _embed_rows(_weight(params["embed"], ("vocab", "fsdp"), cd),
                    tokens, scale, lay, seq=True)
    cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(cfg.n_cycles):
        cycle = [{name: a[c] for name, a in pos.items()}
                 for pos in params["layers"]]
        if cfg.remat and cfg.remat_policy == "block_outs":
            x, aux = _cycle_train(x, aux, cycle, cfg, positions, cos, sin,
                                  run=_run_checkpointed)
        elif cfg.remat:
            x, aux = checkpoint(sl.under_current_rules(_cycle_train), x,
                                aux, cycle, cfg, positions, cos, sin,
                                use_reentrant=False)
        else:
            x, aux = _cycle_train(x, aux, cycle, cfg, positions, cos, sin)
    x = rms_norm(x, params["ln_f"].to(cd))
    return x, aux


def _chunk_loss(xc: torch.Tensor, yc: torch.Tensor, w: torch.Tensor,
                tp=()) -> torch.Tensor:
    """Summed cross-entropy of one chunk: logits a ``compute_dtype``
    product widened to f32.  ``tp``: ``w`` holds this rank's block of
    the vocab columns over those axes (the vocab-parallel loss): the
    log-sum-exp shifts by the ranks' max (``pmax``) and sums their
    ``exp`` (``psum``), and the label's logit comes from the rank that
    holds it (``psum`` of it and zeros)."""
    logits = (xc @ w).float()
    if not tp:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        return (lse - picked).sum()
    v_l = logits.shape[-1]
    m = sl.pmax(logits.amax(dim=-1), tp)
    lse = m + torch.log(sl.psum(torch.exp(logits - m[..., None]).sum(-1),
                                tp))
    idx = yc.long() - sl.axis_index(tp) * v_l
    own = (idx >= 0) & (idx < v_l)
    at = torch.gather(logits, -1, idx.clamp(0, v_l - 1)[..., None])[..., 0]
    picked = sl.psum(torch.where(own, at, torch.zeros_like(at)), tp)
    return (lse - picked).sum()


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (+ the aux loss), with the logits
    made ``loss_chunk`` positions at a time and each chunk recomputed in
    the backward pass (the JAX ``jax.checkpoint(chunk_loss)``), so that
    at most one chunk's logits are alive.  S must be a multiple of the
    chunk, as the JAX reshape requires.  Under a mesh ``tokens`` and
    ``labels`` are this rank's block of the batch, and the loss is the
    whole batch's (the data shards' sums summed), on every rank."""
    x, aux = forward(params, tokens, cfg)
    lay = _layout(cfg)
    x = column_in(x, lay.tp, lay.sp)
    b, s, _ = x.shape
    w = _head(params, cfg)
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"loss_fn: sequence length {s} is not a multiple "
                         f"of loss_chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    chunk_loss = sl.under_current_rules(_chunk_loss)
    vocab = lay.tp if lay.n_tp > 1 else ()      # one rank's is the whole
    for i in range(s // c):
        sl_ = slice(i * c, (i + 1) * c)
        tot = tot + checkpoint(chunk_loss, x[:, sl_], labels[:, sl_], w,
                               vocab, use_reentrant=False)
    return sl.psum(tot, lay.dp) / (b * sl.axis_size(lay.dp) * s) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: TransformerConfig,
           lay: _Layout, seq: bool = False) -> torch.Tensor:
    """Embedding rows in ``compute_dtype`` times ``sqrt(d_model)`` taken
    in that dtype (a host scalar: no copy to the card, no sync); over a
    mesh, the vocab-parallel lookup (``seq``: to the rank's sequence
    block)."""
    cd = cfg.compute_dtype
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=cd)).item()
    table = _weight(params["embed"], ("vocab", "fsdp"), params["embed"].dtype)
    if lay.n_tp == 1:
        return table[tokens].to(cd) * scale
    return _embed_rows(table.to(cd), tokens, scale, lay, seq)


def _layers(params, cfg: TransformerConfig):
    """(cycle, position in cycle, that layer's params cast to
    ``compute_dtype`` and gathered) in the order the JAX scan runs
    them."""
    names = _layer_names(cfg)
    for c in range(cfg.n_cycles):
        for p_i in range(cfg.local_global_period):
            layer = {name: a[c] for name, a in params["layers"][p_i].items()}
            yield c, p_i, _cast_layer(layer, names, cfg, list(layer))


def _cols_whole(y: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """A column-parallel product's block ``y`` [B, N / |tp|] gathered
    whole along its last dim."""
    return sl.all_gather(y, lay.tp, axis=y.dim() - 1)


def decode_step(params, caches, tokens: torch.Tensor, cur_len: int,
                cfg: TransformerConfig):
    """One decode step: tokens [B] int, cur_len int -> (logits [B, V] f32,
    caches).  The new token sits at position ``cur_len``; entries
    [0, cur_len) are valid (a local layer's rolling cache holds the last
    ``window`` of them).  The caches are updated in place and returned.
    An MoE layer routes the step's B tokens as one batch (JAX's
    ``h2[:, None, :]``, so its capacity is JAX's).

    Under a mesh the arguments are this rank's blocks (the caches split
    along their slots, ``kv_seq``): q, k_new and v_new come from the
    rank's columns and are gathered whole over the tensor-parallel axis
    for the split-KV ``attention_decode``, whose output the rank's heads
    take for the row-parallel ``wo``.  The logits are the rank's block
    of the vocab, ``[B, V / |model|]``."""
    lay = _layout(cfg, seq=False)
    b = tokens.shape[0]
    hd = cfg.hd
    h_l = cfg.n_heads // lay.n_tp
    heads = slice(lay.i_tp * h_l * hd, (lay.i_tp + 1) * h_l * hd)
    x = _embed(params, tokens, cfg, lay)                  # [B, D]
    pos = torch.full((1,), int(cur_len), dtype=torch.int32,
                     device=tokens.device)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta)     # [1, 1, hd/2]
    for c, p_i, lp in _layers(params, cfg):
        h = column_in(rms_norm(x, lp["ln1"]), lay.tp, ())
        q = _cols_whole(h @ lp["wq"], lay).reshape(b, cfg.n_heads, hd)
        kn = _cols_whole(h @ lp["wk"], lay).reshape(b, cfg.n_kv_heads, hd)
        vn = _cols_whole(h @ lp["wv"], lay).reshape(b, cfg.n_kv_heads, hd)
        q = rotate(q[:, None], cos, sin)[:, 0]
        kn = rotate(kn[:, None], cos, sin)[:, 0]
        window = cfg.sliding_window if cfg.layer_is_local(p_i) else None
        o, _, _ = attention_decode(q, caches[p_i]["k"][c],
                                   caches[p_i]["v"][c], kn, vn, cur_len,
                                   window=window)
        x = x + row_out(o.reshape(b, cfg.n_heads * hd)[:, heads]
                        @ lp["wo"], lay.tp, ())
        h2 = rms_norm(x, lp["ln2"])
        x = x + _mlp(h2[:, None, :], lp, cfg, lay)[0][:, 0]
    cd = cfg.compute_dtype
    x = rms_norm(x, params["ln_f"].to(cd))
    logits = (x @ _head(params, cfg)).float()
    return logits, caches


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B, S] -> (last-position logits [B, V] f32, caches filled
    [0, S) in ``compute_dtype``, laid out as :func:`make_cache`'s; a
    local layer keeps its last ``min(window, S)`` keys, at slots
    ``0..w-1`` as JAX does.  Decode's slot ``cur % window`` continues
    that ring only when S is at most the window or a multiple of it;
    after another S, JAX's decode evicts a key still inside the window,
    and the port, held to JAX, does the same.

    Under a mesh (``rules_serve_lm``: sequence parallelism) the tokens
    are this rank's block of the batch; the caches come back as the
    rank's blocks of :func:`cache_shardings` (its share of the slots,
    every KV head: ``wk``/``wv`` are gathered whole) and the logits as
    its block of the vocab."""
    lay = _layout(cfg)
    b, s = tokens.shape
    hd = cfg.hd
    cd = cfg.compute_dtype
    h_l = cfg.n_heads // lay.n_tp
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    x = _embed(params, tokens, cfg, lay, seq=True)
    kvs = sl._live_axes("kv_seq")
    n_kvs, i_kvs = sl.axis_size(kvs), sl.axis_index(kvs)
    caches = make_cache(cfg, b, s, dtype=cd, device=tokens.device)
    if n_kvs > 1:
        caches = [{k: sl.local_block(t, sl.P(None, None, kvs))
                   for k, t in pos.items()} for pos in caches]
    for c, p_i, lp in _layers(params, cfg):
        h = column_in(rms_norm(x, lp["ln1"]), lay.tp, lay.sp)
        wk, wv, (lo, hi) = _kv_weights(lp, cfg, lay, whole=True)
        q = (h @ lp["wq"]).reshape(b, s, h_l, hd)
        k = (h @ wk).reshape(b, s, cfg.n_kv_heads, hd)
        v = (h @ wv).reshape(b, s, cfg.n_kv_heads, hd)
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)
        o = _attend(q, k[:, :, lo:hi], v[:, :, lo:hi], cfg,
                    cfg.layer_is_local(p_i), positions)
        w_l = caches[p_i]["k"].shape[2]
        first = s - w_l * n_kvs + i_kvs * w_l
        caches[p_i]["k"][c] = k[:, first:first + w_l]
        caches[p_i]["v"][c] = v[:, first:first + w_l]
        x = x + row_out(o.reshape(b, s, h_l * hd) @ lp["wo"], lay.tp,
                        lay.sp)
        h2 = rms_norm(x, lp["ln2"])
        x = x + _mlp(h2, lp, cfg, lay)[0]
    last = x[:, -1]
    if lay.sp:              # the last position is on the last rank
        if lay.i_tp != lay.n_tp - 1:
            last = torch.zeros_like(last)
        last = sl.psum(last, lay.sp)
    x = rms_norm(last, params["ln_f"].to(cd))
    logits = (x @ _head(params, cfg)).float()
    return logits, caches
