"""Cell builder of the port: (architecture x input shape) -> a step and its
concrete arguments, for serving and for training.

A cell packages what a caller needs to run one assigned shape: the step
function (train / prefill / decode / serve / retrieval), its arguments
as real tensors on the device (random weights from a seeded generator,
inputs from a seeded numpy stream), and the analytic model FLOPs of one
call.  ``smoke=True`` builds the reduced config at the JAX package's
smoke sizes, with the JAX cells' inputs; ``smoke=False`` the full
published config at the assigned shape, allocated for real.  ``batch``
cuts the assigned batch and ``layers`` an LM's depth (``meta["reduced"]``
records each cut): glm4's decode_32k cache at its batch of 128 is 172 GB,
and its 40 layers with f32 AdamW state 170 GB, more than one card holds.

A train cell's step takes ``(state, *batch)`` with ``state = {"params",
"opt"}`` and returns ``(state, {"loss", "gnorm"})``.  It updates the
state **in place** (the JAX cells donate it; here the tables of rm2 are
too large for a second copy) and returns the same dict, so
``cell.run()`` steps on.  ``cell.batch_at(step)`` gives step ``step``'s
batch from the arch's data stream (``TokenStream`` / ``RecsysStream``),
a pure function of (seed, step).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..configs.shapes import SHAPE_PARAMS
from ..data import RecsysStream, TokenStream
from ..device import resolve_device
from ..models import dlrm as dlrm_mod
from ..models import transformer as tf
from ..optim import adamw_init, adamw_update, cosine_schedule
from ..tree import leaves, map_tree, unflatten

SEED = 0          # weights (torch generator on the device) and inputs (numpy)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # train | prefill | decode | serve | retrieval
    family: str
    fn: Callable
    args: Tuple
    model_flops: float
    meta: Dict[str, Any]
    batch_at: Optional[Callable[[int], Tuple]] = None   # train cells

    def run(self):
        return self.fn(*self.args)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_flops(cfg: tf.TransformerConfig, kind: str, batch: int,
              seq: int) -> float:
    """Analytic model FLOPs of one step (the JAX builder's formula for
    dense full-attention archs)."""
    n_act = cfg.active_param_count()
    attn = 4 * cfg.n_heads * cfg.hd * seq / 2  # qk + av per token per layer
    if kind == "train":
        toks = batch * seq
        return 6.0 * n_act * toks + 3 * cfg.n_layers * attn * toks
    if kind == "prefill":
        toks = batch * seq
        return 2.0 * n_act * toks + cfg.n_layers * attn * toks
    # decode: one token per sequence; attention reads the full cache
    per_tok_attn = 4 * cfg.n_heads * cfg.hd * seq * cfg.n_layers
    return batch * (2.0 * n_act + per_tok_attn)


def _on(arrays, device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def lm_value_and_grad(params, tokens: torch.Tensor, labels: torch.Tensor,
                      cfg: tf.TransformerConfig):
    """(loss, grads) of ``tf.loss_fn`` at ``params``: dense f32 grads
    shaped like ``params``, as ``jax.value_and_grad`` gives.  Each
    cycle's slice of a ``[n_cycles, ...]`` stack is its own autograd leaf
    whose ``.grad`` is preset to its slot of a zero-filled stacked
    buffer, so backward accumulates into the buffer in place (a leaf of
    the whole stack would get one stack-sized gradient a cycle)."""
    grads = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)

    def leaf(p, g):
        v = p.detach().requires_grad_(True)
        v.grad = g
        return v
    tree = {k: leaf(params[k], grads[k]) for k in params if k != "layers"}
    tree["layers"] = [{name: [leaf(a[c], gpos[name][c])
                              for c in range(cfg.n_cycles)]
                       for name, a in pos.items()}
                      for pos, gpos in zip(params["layers"],
                                           grads["layers"])]
    with torch.enable_grad():
        loss = tf.loss_fn(tree, tokens, labels, cfg)
        loss.backward()
    return loss.detach(), grads


def _lm_train_step(cfg: tf.TransformerConfig):
    """The JAX LM train step: loss and grads, the cosine schedule on the
    optimizer's count (3e-4 peak, 2,000 warm-up of 200,000 steps), AdamW
    with its defaults (clip 1.0, decay 0.1); in place."""
    def step(state, tokens, labels):
        loss, grads = lm_value_and_grad(state["params"], tokens, labels, cfg)
        lr = cosine_schedule(state["opt"].count, 3e-4, 2000, 200_000)
        _, state["opt"], gnorm = adamw_update(state["params"], grads,
                                              state["opt"], lr)
        return state, {"loss": loss, "gnorm": gnorm}
    return step


def lm_train_layers(cfg: tf.TransformerConfig, device_bytes: int,
                    reserve_bytes: int) -> int:
    """The most layers (at most ``cfg.n_layers``, at least 1) whose f32
    parameters, gradients and AdamW m and v (16 bytes a parameter) fit in
    ``device_bytes`` beside the embedding and head's and
    ``reserve_bytes`` of activations."""
    one = dataclasses.replace(cfg, n_layers=1, local_global_period=1)
    per_layer = one.param_count() - dataclasses.replace(
        one, n_layers=0).param_count()
    fixed = cfg.param_count() - cfg.n_layers * per_layer
    room = device_bytes - reserve_bytes - 16 * fixed
    return max(1, min(cfg.n_layers, room // (16 * per_layer)))


def _build_lm_train_cell(arch_id, shape_name, cfg, smoke, device, meta):
    b, s = meta["batch"], meta["seq_len"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = tf.init_params(cfg, gen, device)          # f32, as JAX trains
    state = {"params": params, "opt": adamw_init(params)}
    stream = TokenStream(vocab=cfg.vocab, batch=b, seq_len=s, seed=SEED)
    if smoke:   # the JAX smoke cell's tokens
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (b, s + 1)).astype(np.int32)
        batch_args = _on((toks[:, :-1], toks[:, 1:]), device)
    else:
        batch_args = _on(stream.batch_at(0), device)
    meta["data"] = "TokenStream"
    return Cell(arch_id, shape_name, "train", "lm", _lm_train_step(cfg),
                (state,) + batch_args, _lm_flops(cfg, "train", b, s), meta,
                batch_at=lambda step: _on(stream.batch_at(step), device))


def _build_lm_cell(arch_id, shape_name, mod, smoke, device, batch,
                   layers=None):
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["lm"][shape_name])
    kind = sp["kind"]
    if smoke:
        sp["seq_len"] = 64 if kind != "decode" else 128
        sp["global_batch"] = 2
    b = sp["global_batch"] if batch is None else batch
    s = sp["seq_len"]
    reduced = {}
    if layers is not None and layers != cfg.n_layers:
        reduced["n_layers"] = [cfg.n_layers, layers]
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if b != sp["global_batch"]:
        reduced["batch"] = [sp["global_batch"], b]
    meta = {"cfg": cfg, "batch": b, "seq_len": s}
    if reduced:
        meta["reduced"] = reduced
    if kind == "train":
        return _build_lm_train_cell(arch_id, shape_name, cfg, smoke, device,
                                    meta)
    gen = torch.Generator(device=device).manual_seed(SEED)
    # serving: bf16 parameters, as the JAX serving cells cast them
    params = tf.init_params(cfg, gen, device, dtype=torch.bfloat16)
    flops = _lm_flops(cfg, kind, b, s)
    if kind == "prefill":
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (b, s)).astype(np.int32)).to(device)
        return Cell(arch_id, shape_name, kind, "lm",
                    functools.partial(tf.prefill, cfg=cfg), (params, toks),
                    flops, meta)
    caches = tf.make_cache(cfg, b, s, dtype=torch.bfloat16, device=device)
    toks = torch.zeros(b, dtype=torch.int32, device=device)
    return Cell(arch_id, shape_name, kind, "lm",
                functools.partial(tf.decode_step, cfg=cfg),
                (params, caches, toks, s - 1), flops, meta)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _dlrm_flops(cfg: dlrm_mod.DLRMConfig, kind: str, batch: int,
                n_cand: int = 0) -> float:
    dims = list(cfg.bot_mlp)
    bot = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    d_top = [cfg.n_interactions + cfg.bot_mlp[-1]] + list(cfg.top_mlp)
    top = sum(d_top[i] * d_top[i + 1] for i in range(len(d_top) - 1))
    inter = (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    per = 2 * (bot + top + inter)
    if kind == "train":
        return 3.0 * batch * per
    if kind == "retrieval":
        return per + 2.0 * n_cand * cfg.embed_dim
    return 1.0 * batch * per


def dlrm_value_and_grad(params, dense: torch.Tensor, sparse: torch.Tensor,
                        labels: torch.Tensor, cfg: dlrm_mod.DLRMConfig):
    """(loss, grads) of ``dlrm.loss_fn`` at ``params``, grads shaped like
    ``params``.  The tables' gradient is the dense one that
    ``bag_sum``'s backward returns, taken as it is (no copy)."""
    tree = unflatten(params, [p.detach().requires_grad_(True)
                              for p in leaves(params)])
    with torch.enable_grad():
        loss = dlrm_mod.loss_fn(tree, dense, sparse, labels, cfg)
        grads = torch.autograd.grad(loss, leaves(tree))
    return loss.detach(), unflatten(params, list(grads))


def _dlrm_train_step(cfg: dlrm_mod.DLRMConfig):
    """The JAX DLRM train step: loss and grads, AdamW at lr 1e-3 with no
    weight decay (clip 1.0); in place."""
    def step(state, dense, sparse, labels):
        loss, grads = dlrm_value_and_grad(state["params"], dense, sparse,
                                          labels, cfg)
        _, state["opt"], gnorm = adamw_update(state["params"], grads,
                                              state["opt"], 1e-3,
                                              weight_decay=0.0)
        return state, {"loss": loss, "gnorm": gnorm}
    return step


def _build_recsys_cell(arch_id, shape_name, mod, smoke, device, batch):
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["recsys"][shape_name])
    kind = sp["kind"]
    full_b = 8 if smoke else sp.get("batch", 1)
    b = full_b if batch is None else batch
    n_cand = 1024 if smoke else sp.get("n_candidates", 0)
    meta = {"cfg": cfg, "batch": b}
    if b != full_b:
        meta["reduced"] = {"batch": [full_b, b]}
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = dlrm_mod.init_params(cfg, gen, device)
    rng = np.random.default_rng(SEED)
    dense = torch.from_numpy(
        rng.normal(size=(b, cfg.n_dense)).astype(np.float32)).to(device)
    sparse = torch.from_numpy(rng.integers(
        0, cfg.vocab_per_table, (b, cfg.n_sparse)).astype(np.int32)).to(device)
    if kind == "train":
        stream = RecsysStream(batch=b, n_dense=cfg.n_dense,
                              n_sparse=cfg.n_sparse,
                              vocab=cfg.vocab_per_table, seed=SEED)
        if smoke:   # the JAX smoke cell's inputs
            labels = torch.from_numpy(
                rng.integers(0, 2, b).astype(np.int32)).to(device)
            batch_args = (dense, sparse, labels)
        else:       # Zipf ids, as training traffic has
            batch_args = _on(stream.batch_at(0), device)
        meta["data"] = "RecsysStream"
        state = {"params": params, "opt": adamw_init(params)}
        return Cell(arch_id, shape_name, kind, "recsys",
                    _dlrm_train_step(cfg), (state,) + batch_args,
                    _dlrm_flops(cfg, kind, b), meta,
                    batch_at=lambda step: _on(stream.batch_at(step), device))
    if kind == "serve":
        return Cell(arch_id, shape_name, kind, "recsys",
                    functools.partial(dlrm_mod.forward, cfg=cfg),
                    (params, dense, sparse), _dlrm_flops(cfg, kind, b), meta)
    cand = torch.from_numpy(rng.integers(
        0, cfg.vocab_per_table, n_cand).astype(np.int32)).to(device)
    meta["n_candidates"] = n_cand
    return Cell(arch_id, shape_name, kind, "recsys",
                functools.partial(dlrm_mod.retrieval_scores, cfg=cfg),
                (params, dense[:1], sparse[:1], cand),
                _dlrm_flops(cfg, kind, 1, n_cand), meta)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, smoke: bool = False,
               device=None, batch: Optional[int] = None,
               layers: Optional[int] = None) -> Cell:
    """The cell ``(arch_id, shape_name)`` with concrete tensors on
    ``device`` (default ``cuda``; raises without a card unless given
    ``"cpu"``).  ``batch`` overrides the assigned batch and ``layers`` an
    LM's depth (cuts, recorded in ``meta["reduced"]``).  Weights and
    inputs come from seed 0."""
    device = resolve_device(device)
    mod = get_arch(arch_id)
    skip = getattr(mod, "SKIP_SHAPES", {})
    if shape_name in skip:
        raise ValueError(f"{arch_id} does not run {shape_name}: "
                         f"{skip[shape_name]}")
    if mod.FAMILY == "lm":
        return _build_lm_cell(arch_id, shape_name, mod, smoke, device, batch,
                              layers)
    if layers is not None:
        raise ValueError(f"{arch_id}: layers= cuts an LM's depth only")
    return _build_recsys_cell(arch_id, shape_name, mod, smoke, device, batch)
