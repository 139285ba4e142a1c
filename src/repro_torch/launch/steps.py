"""Cell builder of the port: (architecture x input shape) -> a step and its
concrete arguments, serving cells only.

A cell packages what a caller needs to run one assigned shape: the step
function (prefill / decode / serve / retrieval), its arguments as real
tensors on the device (random weights from a seeded generator, inputs
from a seeded numpy stream), and the analytic model FLOPs of one call.
``smoke=True`` builds the reduced config at the JAX package's smoke
sizes; ``smoke=False`` the full published config at the assigned shape,
allocated for real.  ``batch`` cuts the assigned batch (``meta``
records the cut): glm4's decode_32k cache at its batch of 128 is 172 GB,
more than one card holds.

Training cells wait for the training slice (``ROADMAP.md`` queue 1,
item 10) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..configs.shapes import SHAPE_PARAMS
from ..device import resolve_device
from ..models import dlrm as dlrm_mod
from ..models import transformer as tf

SEED = 0          # weights (torch generator on the device) and inputs (numpy)
_TRAIN_TODO = ("training cells come with the training slice (ROADMAP.md "
               "queue 1, item 10): backward of both kernels, optimizer")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                      # prefill | decode | serve | retrieval
    family: str
    fn: Callable
    args: Tuple
    model_flops: float
    meta: Dict[str, Any]

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


def _build_lm_cell(arch_id, shape_name, mod, smoke, device, batch):
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["lm"][shape_name])
    kind = sp["kind"]
    if kind == "train":
        raise NotImplementedError(_TRAIN_TODO)
    if smoke:
        sp["seq_len"] = 64 if kind != "decode" else 128
        sp["global_batch"] = 2
    b = sp["global_batch"] if batch is None else batch
    s = sp["seq_len"]
    meta = {"cfg": cfg, "batch": b, "seq_len": s}
    if b != sp["global_batch"]:
        meta["reduced"] = {"batch": [sp["global_batch"], b]}
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


def _build_recsys_cell(arch_id, shape_name, mod, smoke, device, batch):
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["recsys"][shape_name])
    kind = sp["kind"]
    if kind == "train":
        raise NotImplementedError(_TRAIN_TODO)
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
               device=None, batch: Optional[int] = None) -> Cell:
    """The serving cell ``(arch_id, shape_name)`` with concrete tensors on
    ``device`` (default ``cuda``; raises without a card unless given
    ``"cpu"``).  ``batch`` overrides the assigned batch (a cut, recorded
    in ``meta["reduced"]``).  Weights and inputs come from seed 0."""
    device = resolve_device(device)
    mod = get_arch(arch_id)
    skip = getattr(mod, "SKIP_SHAPES", {})
    if shape_name in skip:
        raise ValueError(f"{arch_id} does not run {shape_name}: "
                         f"{skip[shape_name]}")
    build = _build_lm_cell if mod.FAMILY == "lm" else _build_recsys_cell
    return build(arch_id, shape_name, mod, smoke, device, batch)
