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
batch from the arch's data stream (``TokenStream`` / ``RecsysStream``;
a GNN cell's one graph, or a ``NeighborSampler`` block), a pure function
of (seed, step).  A GNN step's batch is one ``GraphBatch``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..configs.shapes import SHAPE_PARAMS
from ..data import (NeighborSampler, RecsysStream, TokenStream,
                    bucket_edges_by_dst, csr_from_edges, make_graph_batch,
                    synth_molecule_batch)
from ..device import resolve_device
from ..models import dlrm as dlrm_mod
from ..models import gnn
from ..models import transformer as tf
from ..models.gnn.common import GraphBatch, n_edge_chunks
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
    """Analytic model FLOPs of one step (the JAX builder's formula: the
    active parameters, and an attention context of S/2 a token, ~W on a
    local layer)."""
    n_act = cfg.active_param_count()
    windowed = cfg.sliding_window and cfg.local_global_period > 1
    period = cfg.local_global_period
    ctx = seq / 2
    if windowed:
        ctx = ((period - 1) / period * min(cfg.sliding_window, seq)
               + (1 / period) * ctx)
    attn = 4 * cfg.n_heads * cfg.hd * ctx  # qk + av per token per layer
    if kind == "train":
        toks = batch * seq
        return 6.0 * n_act * toks + 3 * cfg.n_layers * attn * toks
    if kind == "prefill":
        toks = batch * seq
        return 2.0 * n_act * toks + cfg.n_layers * attn * toks
    # decode: one token per sequence; attention reads the full cache
    per_tok_attn = 4 * cfg.n_heads * cfg.hd * seq
    if windowed:
        per_tok_attn = ((period - 1) / period * 4 * cfg.n_heads * cfg.hd
                        * min(cfg.sliding_window, seq)
                        + (1 / period) * 4 * cfg.n_heads * cfg.hd * seq)
    per_tok_attn *= cfg.n_layers
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
    """The most layers (at most ``cfg.n_layers``, at least one cycle of
    ``local_global_period``, always whole cycles) whose f32 parameters,
    gradients and AdamW m and v (16 bytes a parameter) fit in
    ``device_bytes`` beside the embedding and head's and
    ``reserve_bytes`` of activations."""
    one = dataclasses.replace(cfg, n_layers=1, local_global_period=1)
    per_layer = one.param_count() - dataclasses.replace(
        one, n_layers=0).param_count()
    fixed = cfg.param_count() - cfg.n_layers * per_layer
    room = device_bytes - reserve_bytes - 16 * fixed
    period = cfg.local_global_period
    n = min(cfg.n_layers, room // (16 * per_layer))
    return max(period, n - n % period)


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
        if layers < 1 or layers % cfg.local_global_period:
            raise ValueError(
                f"{arch_id}: layers={layers} is not a positive multiple of "
                f"its {cfg.local_global_period}-layer cycle")
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
# GNN cells
# ---------------------------------------------------------------------------

GNN_MODULES = gnn.MODULES


def _gnn_cell_config(arch_id, cfg, sp, smoke, variant="base"):
    """Adapt the family config to the cell's dataset (input dim, classes,
    task level, edge chunking, layout variant)."""
    d_feat = sp.get("d_feat", 0)
    n_classes = sp.get("n_classes", 2)
    repl: Dict[str, Any] = {}
    big_e = (not smoke) and sp.get("n_edges", 0) > 2_000_000
    if arch_id == "gcn-cora":
        repl = dict(d_in=d_feat if d_feat else 16, n_classes=n_classes)
    elif arch_id == "gin-tu":
        repl = dict(d_in=d_feat if d_feat else 16, n_classes=n_classes,
                    node_level="batch" not in sp)
    elif arch_id == "schnet":
        repl = dict(d_in=d_feat, n_targets=n_classes)
    else:  # equiformer-v2
        repl = dict(d_in=d_feat, n_targets=n_classes)
    if big_e:
        repl["edge_chunk"] = 1 << 20 if arch_id == "equiformer-v2" else 1 << 22
    if variant == "opt":
        repl["edge_layout"] = ("dst_ranged" if arch_id == "equiformer-v2"
                               else "partitioned")
    return dataclasses.replace(cfg, **repl)


def _node_level(arch_id: str, sp) -> bool:
    """GCN has no graph readout — always node-level (molecule labels are
    broadcast to nodes); others are graph-level on packed-molecule cells."""
    return arch_id == "gcn-cora" or "batch" not in sp


def _gnn_concrete_batch(arch_id, sp, smoke_scale=True,
                        device=None) -> GraphBatch:
    """The JAX builder's concrete batch of a cell: packed molecules (GCN
    and GIN get one-hot atom types, GCN the graph labels on its nodes),
    else a ``make_graph_batch`` graph at the smoke size or the shape's.
    The full ``minibatch_lg`` cell samples blocks instead
    (:func:`_minibatch_sampler`)."""
    geo = arch_id in ("schnet", "equiformer-v2")
    if "batch" in sp:
        g = synth_molecule_batch(batch=4 if smoke_scale else sp["batch"],
                                 n_nodes=sp["n_nodes"],
                                 n_edges=sp["n_edges"],
                                 n_classes=sp["n_classes"], device=device)
        if not geo:  # gcn/gin want dense features: one-hot atom types
            g = dataclasses.replace(g, node_feat=torch.nn.functional.one_hot(
                g.node_feat.long() % 16, 16).to(torch.float32))
        if _node_level(arch_id, sp):  # gcn: broadcast graph labels to nodes
            g = dataclasses.replace(
                g, labels=g.labels[g.graph_ids.long()], graph_ids=None,
                train_mask=torch.ones(g.n_nodes, dtype=torch.bool,
                                      device=g.src.device))
        return g
    n = 64 if smoke_scale else sp["n_nodes"]
    e = 256 if smoke_scale else sp["n_edges"]
    return make_graph_batch(n, e, min(sp.get("d_feat", 16), 32)
                            if smoke_scale else sp.get("d_feat", 16),
                            n_classes=sp["n_classes"],
                            with_geometry=True, device=device)


def _minibatch_sampler(sp, device) -> NeighborSampler:
    """The host graph of ``minibatch_lg`` (Reddit's node and edge counts,
    uniform random edges, normal features, uniform labels; seeded) in
    numpy, as an in-neighbour CSR behind a ``NeighborSampler`` at the
    shape's fanout.  Nothing of it goes to the card but the blocks."""
    n, e = sp["n_nodes"], sp["n_edges"]
    rng = np.random.default_rng(SEED)
    src = rng.integers(0, n, e, dtype=np.int32)
    dst = rng.integers(0, n, e, dtype=np.int32)
    ptr, nbr = csr_from_edges(n, src, dst)
    del src, dst
    feats = rng.standard_normal((n, sp["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, sp["n_classes"], n).astype(np.int32)
    # the sampler's stream is seeded apart from the batch ids' stream
    return NeighborSampler(ptr, nbr, feats, labels, fanout=sp["fanout"],
                           seed=SEED + 1, device=device)


def _dst_ranged(g: GraphBatch, edge_chunk: int) -> GraphBatch:
    """``g``'s edges bucketed by destination into the chunks that
    EquiformerV2's ``dst_ranged`` layout reads: as many buckets as chunks
    of ``edge_chunk`` edges after the 1.15x padding of
    ``bucket_edges_by_dst``."""
    e = g.src.shape[0]
    n_buckets = -(-int(np.ceil(e * 1.15)) // edge_chunk)
    out = bucket_edges_by_dst(g, n_buckets)
    if n_edge_chunks(out.src.shape[0], edge_chunk) != n_buckets:
        raise ValueError(f"{out.src.shape[0]} bucketed edges do not fall in "
                         f"{n_buckets} chunks of {edge_chunk}")
    return out


def _gnn_flops(arch_id, cfg, n, e):
    d = getattr(cfg, "d_hidden", 16)
    if arch_id == "gcn-cora":
        per = cfg.d_in * d * n + e * d + n * d * cfg.n_classes
        return 3.0 * 2 * per
    if arch_id == "gin-tu":
        per = cfg.n_layers * (e * d + 2 * n * d * d)
        return 3.0 * 2 * per
    if arch_id == "schnet":
        per = cfg.n_interactions * (e * (cfg.n_rbf * d + d * d)
                                    + 3 * n * d * d)
        return 3.0 * 2 * per
    # equiformer: per-edge eSCN cost = rotation build/compose/apply +
    # per-m dense SO(2) mixes over (l, channel)
    rot_apply = 4 * d * sum((2 * l + 1) ** 2
                            for l in range(cfg.l_max + 1))   # to+from frame
    rot_build = 6 * sum((2 * l + 1) ** 3 for l in range(cfg.l_max + 1))
    n0 = cfg.l_max + 1
    so2 = 2 * (n0 * d) ** 2
    for m in range(1, cfg.m_max + 1):
        so2 += 4 * ((cfg.l_max + 1 - m) * d) ** 2
    per_edge = rot_apply + rot_build + so2
    per = cfg.n_layers * (e * per_edge + n * (cfg.l_max + 1) * 2 * d * d)
    return 3.0 * per


def _gnn_train_step(model, cfg):
    """The JAX GNN train step: loss and grads, AdamW at lr 1e-3 with no
    weight decay (clip 1.0); in place."""
    def step(state, batch: GraphBatch):
        loss, grads = value_and_grad(
            lambda p: model.loss_fn(p, batch, cfg), state["params"])
        _, state["opt"], gnorm = adamw_update(state["params"], grads,
                                              state["opt"], 1e-3,
                                              weight_decay=0.0)
        return state, {"loss": loss, "gnorm": gnorm}
    return step


def _build_gnn_cell(arch_id, shape_name, mod, smoke, device,
                    variant="base"):
    """A GNN train cell.  ``smoke``: the JAX smoke cell (reduced config,
    the smoke batch; ``variant`` is ignored there, as in JAX).  Else the
    published config at the shape: ``full_graph_sm`` and ``ogb_products``
    train on one synthetic graph every step, ``molecule`` on 128 packed
    molecules, and ``minibatch_lg`` on a ``NeighborSampler`` block a
    step (its declared shape in the JAX cell), 1,024 seed nodes drawn
    from ``default_rng((SEED, step))``.  ``variant="opt"``: the JAX
    cell's owner-bucketed layouts (GCN, GIN and SchNet "partitioned", on
    one device any edge order; EquiformerV2 "dst_ranged", its edges
    bucketed when they span more than one chunk)."""
    base = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["gnn"][shape_name])
    model = GNN_MODULES[arch_id]
    meta: Dict[str, Any] = {}
    if smoke:
        cfg = _gnn_cell_config(arch_id, base,
                               {**sp, "d_feat": min(sp.get("d_feat", 16), 32),
                                "n_classes": sp["n_classes"]}, smoke=True)
        batch = _gnn_concrete_batch(arch_id, sp, device=device)
        cfg = dataclasses.replace(
            cfg, d_in=(batch.node_feat.shape[1]
                       if batch.node_feat.dim() == 2 else 0))
        batch_at = lambda step: (batch,)  # noqa: E731
        meta["data"] = "smoke batch"
    else:
        cfg = _gnn_cell_config(arch_id, base, sp, smoke=False,
                               variant=variant)
        if "batch_nodes" in sp:
            sampler = _minibatch_sampler(sp, device)

            def batch_at(step):
                ids = np.random.default_rng((SEED, step)).choice(
                    sp["n_nodes"], sp["batch_nodes"], replace=False)
                return (sampler.sample(ids, step),)
            batch = batch_at(0)[0]
            meta.update(data="NeighborSampler",
                        host_graph=(sp["n_nodes"], sp["n_edges"]),
                        block=sampler.block_shape(sp["batch_nodes"]))
        else:
            batch = _gnn_concrete_batch(arch_id, sp, smoke_scale=False,
                                        device=device)
            if (cfg.edge_layout == "dst_ranged"
                    and n_edge_chunks(batch.src.shape[0], cfg.edge_chunk) > 1):
                batch = _dst_ranged(batch, cfg.edge_chunk)
            batch_at = lambda step: (batch,)  # noqa: E731
            meta["data"] = ("synth_molecule_batch" if "batch" in sp
                            else "make_graph_batch")
        if batch.node_feat.dim() == 1:
            cfg = dataclasses.replace(cfg, d_in=0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = model.init_params(cfg, gen, device)
    state = {"params": params, "opt": adamw_init(params)}
    meta.update(cfg=cfg, n_nodes=batch.n_nodes,
                n_edges=int(batch.src.shape[0]))
    return Cell(arch_id, shape_name, "train", "gnn",
                _gnn_train_step(model, cfg), (state, batch),
                _gnn_flops(arch_id, cfg, batch.n_nodes, batch.src.shape[0]),
                meta, batch_at=batch_at)


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


def value_and_grad(loss_of: Callable, params):
    """(loss, grads) of ``loss_of(params)``, grads shaped like ``params``
    (zeros for a leaf the loss does not reach, as JAX gives)."""
    tree = unflatten(params, [p.detach().requires_grad_(True)
                              for p in leaves(params)])
    with torch.enable_grad():
        loss = loss_of(tree)
        grads = torch.autograd.grad(loss, leaves(tree), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(params), grads)]
    return loss.detach(), unflatten(params, grads)


def dlrm_value_and_grad(params, dense: torch.Tensor, sparse: torch.Tensor,
                        labels: torch.Tensor, cfg: dlrm_mod.DLRMConfig):
    """(loss, grads) of ``dlrm.loss_fn`` at ``params``, grads shaped like
    ``params``.  The tables' gradient is the dense one that
    ``bag_sum``'s backward returns, taken as it is (no copy)."""
    return value_and_grad(
        lambda p: dlrm_mod.loss_fn(p, dense, sparse, labels, cfg), params)


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
               layers: Optional[int] = None, variant: str = "base") -> Cell:
    """The cell ``(arch_id, shape_name)`` with concrete tensors on
    ``device`` (default ``cuda``; raises without a card unless given
    ``"cpu"``).  ``batch`` overrides the assigned batch of an LM or DLRM
    cell and ``layers`` an LM's depth (cuts, recorded in
    ``meta["reduced"]``); ``variant="opt"`` picks a GNN cell's bucketed
    edge layouts.  Weights and inputs come from seed 0."""
    device = resolve_device(device)
    mod = get_arch(arch_id)
    skip = getattr(mod, "SKIP_SHAPES", {})
    if shape_name in skip:
        raise ValueError(f"{arch_id} does not run {shape_name}: "
                         f"{skip[shape_name]}")
    if variant not in ("base", "opt"):
        raise ValueError(f"variant must be 'base' or 'opt', got {variant!r}")
    if variant != "base" and mod.FAMILY != "gnn":
        raise NotImplementedError(f"{arch_id}: only the GNN cells have an "
                                  "'opt' variant in the port")
    if mod.FAMILY == "lm":
        return _build_lm_cell(arch_id, shape_name, mod, smoke, device, batch,
                              layers)
    if layers is not None:
        raise ValueError(f"{arch_id}: layers= cuts an LM's depth only")
    if mod.FAMILY == "gnn":
        if batch is not None:
            raise ValueError(f"{arch_id}: batch= cuts an LM or DLRM batch "
                             "only")
        return _build_gnn_cell(arch_id, shape_name, mod, smoke, device,
                               variant)
    return _build_recsys_cell(arch_id, shape_name, mod, smoke, device, batch)
