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

Built under ``shardlib.axis_rules(mesh, rules_for(arch, shape, mesh))``
a cell carries ``in_shardings``: one ``NamedSharding`` a leaf of its
arguments, resolved from the logical axis rules (the JAX cells' trees).
Every cell then holds this rank's blocks and runs sharded under the
same rules (``cell.run()`` inside the ``with``): a train step sums each
gradient block over the ranks its uses are partial on and clips to the
whole model's norm.  An LM's or DLRM's state never exists whole on a
rank: its weights are the keyed draw (``models/init.py``), each leaf a
function of (SEED, its path, the element's position), so each rank
draws only the tiles its blocks meet, bit-equal to the cut of the
weights a world-1 cell draws whole; AdamW's m and v and the KV caches
are zeros made at block size.  ``local_block`` cuts only the inputs
(tokens, DLRM rows, candidates), which every rank makes whole from the
same numpy stream.  A GNN cell's parameters are replicated and drawn
whole from a seeded generator; its graph is laid out for its node
blocks (:func:`gnn_mesh_layout`: padded, and bucketed by owner for the
``opt`` layouts) and cut; a layout the mesh cannot hold raises, naming
the arch and the mesh.  ``draw=False`` leaves the state uninitialised
(``torch.empty`` blocks) for a restore to fill: nothing is drawn.

``abstract=True`` is the JAX builder's ``eval_shape`` path: every leaf of
the cell's arguments is a fake tensor (``FakeTensorMode``) on
:func:`~repro_torch.device.fake_device` with the shape and dtype of the
concrete cell's leaf, this rank's block under axis rules.  Nothing is
drawn on the host or the card: the LM and DLRM weights are their keyed
blocks left undrawn, a GNN's come from its initializer run on fake CPU
tensors, and the inputs (tokens, DLRM rows, a GNN cell's graph and its
layout over the mesh) are empty tensors of the concrete inputs' shapes.
The cell's step runs under ``cell.meta["fake_mode"]``; the dry run
(:mod:`.dryrun`) counts it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import shardlib as sl
from ..configs import get_arch
from ..configs.shapes import SHAPE_PARAMS
from ..data import (NeighborSampler, RecsysStream, TokenStream,
                    bucket_edges_by_dst, csr_from_edges, make_graph_batch,
                    synth_molecule_batch)
from ..data.graphs import stub_edge_feat
from ..data.sampler import block_shape
from ..device import fake_device, resolve_device
from ..models import dlrm as dlrm_mod
from ..models import gnn
from ..models import transformer as tf
from ..models.convert import local_blocks
from ..models.gnn.common import GraphBatch, n_edge_chunks, node_axes
from ..optim import OptState, adamw_init, adamw_update, cosine_schedule
from ..tree import leaves, map_tree, unflatten
from . import mesh as mesh_mod

SEED = 0     # weights (the keyed draw's seed; a GNN's generator) and inputs
#: The LM smoke cells' sequence length (the JAX smoke cells'), and a
#: smoke decode cell's cache length.
SMOKE_SEQ, SMOKE_DECODE_SEQ = 64, 128


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
    in_shardings: Optional[Tuple] = None   # under axis rules

    def run(self):
        return self.fn(*self.args)


# ---------------------------------------------------------------------------
# sharding resolution helpers
# ---------------------------------------------------------------------------

def _resolve(logical_tree):
    """A tree of logical-axis tuples (or None) -> the same tree of
    ``NamedSharding``s under the current rules (dicts and lists are
    inner nodes, a tuple or None a leaf)."""
    if isinstance(logical_tree, dict):
        return {k: _resolve(v) for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [_resolve(v) for v in logical_tree]
    return sl.sharding_for(*(logical_tree or ()))


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def rules_for(arch_id: str, shape_name: str, mesh):
    """The logical axis rules of a cell's workload kind."""
    mod = get_arch(arch_id)
    params = SHAPE_PARAMS[mod.FAMILY][shape_name]
    kind = params["kind"]
    if mod.FAMILY == "lm":
        if kind == "train":
            return mesh_mod.rules_train_lm(mesh)
        return mesh_mod.rules_serve_lm(mesh, params["global_batch"])
    if mod.FAMILY == "gnn":
        return mesh_mod.rules_gnn(mesh)
    return mesh_mod.rules_recsys(mesh, params.get("batch", 0))


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


def _empty(device, *specs) -> Tuple[torch.Tensor, ...]:
    """An abstract cell's inputs: one empty tensor a ``(shape, dtype)``."""
    return tuple(torch.empty(shape, dtype=dtype, device=device)
                 for shape, dtype in specs)


def _abstract(tree, device):
    """``tree`` with every tensor leaf an empty one of its shape and
    dtype on ``device`` (fake under the active ``FakeTensorMode``)."""
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), tree)


def _init(model, cfg, device, abstract: bool, draw: bool = True, **kw):
    """An LM's or DLRM's weights, ``model.init_params(cfg, device=,
    shardings=, draw=, **kw)``: the keyed draw (seed 0, SEED), this
    rank's blocks under the current rules (``model.param_shardings``)
    and the whole leaves without them; abstract or ``draw=False``, the
    same blocks uninitialised (fake under the active
    ``FakeTensorMode``)."""
    psh = (_resolve(model.param_shardings(cfg))
           if sl.current_rules() is not None else None)
    return model.init_params(cfg, device=device, shardings=psh,
                             draw=draw and not abstract, **kw)


def _gnn_init(init, cfg, device, abstract: bool, draw: bool = True):
    """``init(cfg, generator, device)``: a GNN's replicated weights drawn
    whole from SEED by a generator on ``device``; abstract or
    ``draw=False``, empty tensors of their shapes and dtypes on
    ``device``, from the initializer run on fake CPU tensors (no
    generator on the card, nothing drawn)."""
    if not abstract and draw:
        return init(cfg, torch.Generator(device=device).manual_seed(SEED),
                    device)
    fresh = None if detect_fake_mode() else FakeTensorMode(
        allow_non_fake_inputs=True)
    with fresh or contextlib.nullcontext():
        shapes = init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    return _abstract(shapes, device)


def _partial_axes() -> Tuple[str, ...]:
    """The mesh axes an LM gradient block is partial on unless its leaf
    is split over them: the batch's (each data shard sees its own
    tokens) and the sequence's (a leaf held whole over the
    tensor-parallel ranks, a norm scale or the MoE router, sees the
    rank's block of the sequence)."""
    return tuple(dict.fromkeys(sl._live_axes("batch")
                               + sl._live_axes("seq")))


def lm_value_and_grad(params, tokens: torch.Tensor, labels: torch.Tensor,
                      cfg: tf.TransformerConfig):
    """(loss, grads) of ``tf.loss_fn`` at ``params``: dense f32 grads
    shaped like ``params``, as ``jax.value_and_grad`` gives.  Each
    cycle's slice of a ``[n_cycles, ...]`` stack is its own autograd leaf
    whose ``.grad`` is preset to its slot of a zero-filled stacked
    buffer, so backward accumulates into the buffer in place (a leaf of
    the whole stack would get one stack-sized gradient a cycle).

    Under a mesh ``params`` are this rank's blocks, the loss is the
    whole batch's, and each gradient block is summed after the backward
    over the axes its leaf's uses are partial on and does not split
    (``shardlib.reduce_grads``): each block then equals the unsharded
    gradient's block."""
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
    if sl.current_mesh() is not None:
        sl.reduce_grads(grads, _resolve(tf.param_shardings(cfg)),
                        _partial_axes())
    return loss.detach(), grads


def _lm_train_step(cfg: tf.TransformerConfig):
    """The JAX LM train step: loss and grads, the cosine schedule on the
    optimizer's count (3e-4 peak, 2,000 warm-up of 200,000 steps), AdamW
    with its defaults (clip 1.0, decay 0.1); in place.  Under a mesh, on
    this rank's blocks, clipped to the whole model's norm."""
    def step(state, tokens, labels):
        loss, grads = lm_value_and_grad(state["params"], tokens, labels, cfg)
        lr = cosine_schedule(state["opt"].count, 3e-4, 2000, 200_000)
        shardings = (_resolve(tf.param_shardings(cfg))
                     if sl.current_mesh() is not None else None)
        _, state["opt"], gnorm = adamw_update(state["params"], grads,
                                              state["opt"], lr,
                                              shardings=shardings)
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


def _build_lm_train_cell(arch_id, shape_name, cfg, smoke, device, meta,
                         abstract=False, draw=True):
    b, s = meta["batch"], meta["seq_len"]
    params = _init(tf, cfg, device, abstract, draw)  # f32, as JAX trains
    if abstract:
        batch_args = _empty(device, ((b, s), torch.int32),
                            ((b, s), torch.int32))
        batch_at = lambda step: batch_args  # noqa: E731
    else:
        stream = TokenStream(vocab=cfg.vocab, batch=b, seq_len=s, seed=SEED)
        if smoke:   # the JAX smoke cell's tokens
            toks = np.random.default_rng(SEED).integers(
                0, cfg.vocab, (b, s + 1)).astype(np.int32)
            batch_args = _on((toks[:, :-1], toks[:, 1:]), device)
        else:
            batch_args = _on(stream.batch_at(0), device)
        batch_at = lambda step: _on(stream.batch_at(step),  # noqa: E731
                                    device)
    meta["data"] = "TokenStream"
    in_sh = None
    if sl.current_rules() is not None:
        psh = _resolve(tf.param_shardings(cfg))
        tok = sl.sharding_for("batch", None)
        in_sh = ({"params": psh,
                  "opt": OptState(m=psh, v=psh, count=sl.sharding_for())},
                 tok, tok)
        batch_args = local_blocks(batch_args, in_sh[1:])
        whole_at = batch_at
        batch_at = lambda step: local_blocks(  # noqa: E731
            whole_at(step), in_sh[1:])
    state = {"params": params, "opt": adamw_init(params)}
    return Cell(arch_id, shape_name, "train", "lm", _lm_train_step(cfg),
                (state,) + batch_args, _lm_flops(cfg, "train", b, s), meta,
                batch_at=batch_at, in_shardings=in_sh)


def lm_cell_config(arch_id: str, smoke: bool = False,
                   variant: str = "base") -> tf.TransformerConfig:
    """An LM cell's config: the smoke config, or the published one.
    ``variant="opt"`` is the JAX package's ``_OptLM``: the published
    config trains with ``attn_opt`` and the ``block_outs`` remat policy;
    the smoke config stays the base one, as JAX's does."""
    mod = get_arch(arch_id)
    if smoke:
        return mod.smoke_config()
    if variant == "opt":
        return dataclasses.replace(mod.CONFIG, attn_opt=True,
                                   remat_policy="block_outs")
    return mod.CONFIG


def _build_lm_cell(arch_id, shape_name, smoke, device, batch, layers=None,
                   variant="base", abstract=False, draw=True):
    cfg = lm_cell_config(arch_id, smoke, variant)
    sp = dict(SHAPE_PARAMS["lm"][shape_name])
    kind = sp["kind"]
    if smoke:
        sp["seq_len"] = SMOKE_SEQ if kind != "decode" else SMOKE_DECODE_SEQ
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
    meta = {"cfg": cfg, "batch": b, "seq_len": s, "variant": variant}
    if reduced:
        meta["reduced"] = reduced
    if kind == "train":
        return _build_lm_train_cell(arch_id, shape_name, cfg, smoke, device,
                                    meta, abstract, draw)
    # serving: bf16 parameters, as the JAX serving cells cast them (each
    # tile of the draw cast on its own)
    params = _init(tf, cfg, device, abstract, draw, dtype=torch.bfloat16)
    flops = _lm_flops(cfg, kind, b, s)
    ruled = sl.current_rules() is not None
    if kind == "prefill":
        tokens = (_empty(device, ((b, s), torch.int32))[0] if abstract else
                  torch.from_numpy(np.random.default_rng(SEED).integers(
                      0, cfg.vocab, (b, s)).astype(np.int32)).to(device))
        in_sh = ((_resolve(tf.param_shardings(cfg)),
                  sl.sharding_for("batch", None)) if ruled else None)
        args = (params,) + (local_blocks((tokens,), in_sh[1:]) if ruled
                            else (tokens,))
        fn = functools.partial(tf.prefill, cfg=cfg)
    else:
        in_sh = ((_resolve(tf.param_shardings(cfg)),
                  _resolve(tf.cache_shardings(cfg)), sl.sharding_for("batch"),
                  sl.sharding_for()) if ruled else None)
        cache = tf.make_cache(cfg, b, s, dtype=torch.bfloat16, device=device,
                              shardings=in_sh[1] if ruled else None)
        pos = torch.zeros(b, dtype=torch.int32, device=device)
        args = (params, cache,
                local_blocks(pos, in_sh[2]) if ruled else pos, s - 1)
        fn = functools.partial(tf.decode_step, cfg=cfg)
    return Cell(arch_id, shape_name, kind, "lm", fn, args, flops, meta,
                in_shardings=in_sh)


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


def _gnn_abstract_batch(arch_id, sp, smoke: bool, device) -> GraphBatch:
    """The shapes and dtypes of :func:`_gnn_concrete_batch`'s graph (of a
    ``NeighborSampler`` block for the full ``minibatch_lg`` cell), as
    empty tensors on ``device``: nothing drawn."""
    geo = arch_id in ("schnet", "equiformer-v2")
    i32, f32 = torch.int32, torch.float32
    node_level = _node_level(arch_id, sp)
    if "batch" in sp:                           # packed molecules
        n_graphs = 4 if smoke else sp["batch"]
        n, e = n_graphs * sp["n_nodes"], n_graphs * sp["n_edges"]
        feat = ((n,), i32) if geo else ((n, 16), f32)   # one-hot for gcn/gin
    else:
        n_graphs = 1
        if smoke:
            n, e, d = 64, 256, min(sp.get("d_feat", 16), 32)
        elif "batch_nodes" in sp:
            (n, e), d = block_shape(sp["batch_nodes"], sp["fanout"]), \
                sp["d_feat"]
        else:
            n, e, d = sp["n_nodes"], sp["n_edges"], sp.get("d_feat", 16)
        feat = ((n, d), f32)
    src, dst, node_feat, edge_feat = _empty(
        device, ((e,), i32), ((e,), i32), feat, ((e, 3), f32))
    graph_ids = labels = train_mask = None
    if node_level:
        labels, train_mask = _empty(device, ((n,), i32), ((n,), torch.bool))
    else:
        graph_ids, labels = _empty(device, ((n,), i32), ((n_graphs,), i32))
    return GraphBatch(n_nodes=n, n_graphs=n_graphs, src=src, dst=dst,
                      node_feat=node_feat, edge_feat=edge_feat,
                      graph_ids=graph_ids, labels=labels,
                      train_mask=train_mask)


def _resized(g: GraphBatch, n: int, e: int) -> GraphBatch:
    """Empty tensors of ``g``'s dtypes for ``n`` nodes and ``e`` edges
    (an abstract graph laid out): a node-level graph gets a mask."""
    node_level = g.graph_ids is None

    def rows(t, k):
        return None if t is None else torch.empty(
            (k,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    mask = g.train_mask
    if mask is None and node_level:
        mask = g.src.new_empty((n,), dtype=torch.bool)
    return dataclasses.replace(
        g, n_nodes=n, src=rows(g.src, e), dst=rows(g.dst, e),
        node_feat=rows(g.node_feat, n), edge_feat=rows(g.edge_feat, e),
        graph_ids=rows(g.graph_ids, n),
        labels=rows(g.labels, n) if node_level else g.labels,
        train_mask=rows(mask, n))


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


def _dst_ranged(g: GraphBatch, edge_chunk: int,
                abstract: bool = False) -> GraphBatch:
    """``g``'s edges bucketed by destination into the chunks that
    EquiformerV2's ``dst_ranged`` layout reads: as many buckets as chunks
    of ``edge_chunk`` edges after the 1.15x padding of
    ``bucket_edges_by_dst`` (abstract: its shapes, each bucket at that
    padding's cap)."""
    e = g.src.shape[0]
    n_buckets = -(-int(np.ceil(e * 1.15)) // edge_chunk)
    out = (_resized(g, g.n_nodes, n_buckets * int(np.ceil(
        e / n_buckets * 1.15))) if abstract
        else bucket_edges_by_dst(g, n_buckets))
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


def _replicated(tree):
    """A ``NamedSharding`` of the whole tensor for each leaf of
    ``tree`` (None without rules)."""
    if sl.current_rules() is None:
        return None
    return map_tree(lambda _: sl.sharding_for(), tree)


def gnn_value_and_grad(model, params, batch: GraphBatch, cfg):
    """(loss, grads) of ``model.loss_fn`` at ``params`` (grads shaped
    like ``params``).  Under a mesh ``batch`` holds this rank's node and
    edge blocks and the loss is the whole graph's; each rank's edges and
    nodes give a partial gradient of the replicated parameters, summed
    over the node axes (``shardlib.reduce_grads``)."""
    loss, grads = value_and_grad(lambda p: model.loss_fn(p, batch, cfg),
                                 params)
    if sl.current_mesh() is not None:
        sl.reduce_grads(grads, _replicated(grads), node_axes())
    return loss, grads


def _gnn_train_step(model, cfg):
    """The JAX GNN train step: loss and grads, AdamW at lr 1e-3 with no
    weight decay (clip 1.0); in place.  Under a mesh, on this rank's
    blocks (:func:`gnn_value_and_grad`)."""
    def step(state, batch: GraphBatch):
        loss, grads = gnn_value_and_grad(model, state["params"], batch, cfg)
        _, state["opt"], gnorm = adamw_update(
            state["params"], grads, state["opt"], 1e-3, weight_decay=0.0,
            shardings=_replicated(grads))
        return state, {"loss": loss, "gnorm": gnorm}
    return step


def _build_gnn_cell(arch_id, shape_name, mod, smoke, device,
                    variant="base", abstract=False, draw=True):
    """A GNN train cell.  ``smoke``: the JAX smoke cell (reduced config,
    the smoke batch; ``variant="opt"`` gives its edges the opt layout,
    where the JAX smoke cell ignores the variant: both layouts compute
    its loss).  Else the
    published config at the shape: ``full_graph_sm`` and ``ogb_products``
    train on one synthetic graph every step, ``molecule`` on 128 packed
    molecules, and ``minibatch_lg`` on a ``NeighborSampler`` block a
    step (its declared shape in the JAX cell), 1,024 seed nodes drawn
    from ``default_rng((SEED, step))``.  ``variant="opt"``: the JAX
    cell's owner-bucketed layouts (GCN, GIN and SchNet "partitioned", on
    one device any edge order; EquiformerV2 "dst_ranged", its edges
    bucketed when they span more than one chunk).  Under axis rules the
    cell is :func:`shard_train_cell` of this one.  ``abstract``: the
    graph's shapes (:func:`_gnn_abstract_batch`), nothing sampled."""
    base = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["gnn"][shape_name])
    model = GNN_MODULES[arch_id]
    meta: Dict[str, Any] = {}
    if smoke:
        cfg = _gnn_cell_config(arch_id, base,
                               {**sp, "d_feat": min(sp.get("d_feat", 16), 32),
                                "n_classes": sp["n_classes"]}, smoke=True,
                               variant=variant)
        batch = (_gnn_abstract_batch(arch_id, sp, True, device) if abstract
                 else _gnn_concrete_batch(arch_id, sp, device=device))
        cfg = dataclasses.replace(
            cfg, d_in=(batch.node_feat.shape[1]
                       if batch.node_feat.dim() == 2 else 0))
        batch_at = lambda step: (batch,)  # noqa: E731
        meta["data"] = "smoke batch"
    else:
        cfg = _gnn_cell_config(arch_id, base, sp, smoke=False,
                               variant=variant)
        if abstract:
            batch = _gnn_abstract_batch(arch_id, sp, False, device)
            if (cfg.edge_layout == "dst_ranged"
                    and n_edge_chunks(batch.src.shape[0], cfg.edge_chunk) > 1):
                batch = _dst_ranged(batch, cfg.edge_chunk, abstract=True)
            batch_at = lambda step: (batch,)  # noqa: E731
            meta["data"] = ("NeighborSampler" if "batch_nodes" in sp else
                            "synth_molecule_batch" if "batch" in sp
                            else "make_graph_batch")
        elif "batch_nodes" in sp:
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
    params = _gnn_init(model.init_params, cfg, device, abstract, draw)
    state = {"params": params, "opt": adamw_init(params)}
    meta.update(cfg=cfg, n_nodes=batch.n_nodes,
                n_edges=int(batch.src.shape[0]))
    meta["abstract"] = abstract
    cell = Cell(arch_id, shape_name, "train", "gnn",
                _gnn_train_step(model, cfg), (state, batch),
                _gnn_flops(arch_id, cfg, batch.n_nodes, batch.src.shape[0]),
                meta, batch_at=batch_at)
    if sl.current_rules() is not None:
        cell = shard_train_cell(cell)
    return cell


def _mesh_text(mesh) -> str:
    names = tuple(mesh.mesh_dim_names)
    return "mesh " + "x".join(str(mesh.size(i)) for i in range(len(names))) \
        + f" over {names}"


def gnn_mesh_layout(arch_id: str, cfg, g: GraphBatch,
                    abstract: bool = False) -> GraphBatch:
    """The whole graph ``g`` laid out for the node blocks of the current
    rules' mesh (the JAX cell pads its shapes to the mesh the same way):
    ``g`` itself where the nodes split over one rank.  Else, S ranks
    over the node axes:

    * ``n`` is padded to a multiple of S (of the chunk count for
      ``dst_ranged``): a padded node has zero features, label 0,
      ``train_mask`` False (a node-level graph without a mask gets one)
      and graph id ``n_graphs`` (the sentinel graph), and no edge;
      sentinel edges are re-pointed from the old ``n`` to the new one,
      so padding leaves the loss as it was;
    * "arbitrary" edges are padded with sentinel edges to a multiple of
      S; "partitioned" ones bucketed by destination owner, one bucket a
      node block (``partitioned_aggregate``'s precondition); chunked
      "dst_ranged" ones re-bucketed into their chunks over the padded
      ranges, each chunk's range inside one node block, which needs the
      chunk count to be a multiple of S.  Where it is not, this raises,
      naming the arch and the mesh.

    :func:`shard_train_cell` cuts the rank's blocks from the result.
    ``abstract``: ``g``'s shapes laid out (empty tensors); a
    "partitioned" layout's buckets, whose fullest one the graph decides,
    are taken at the 1.15x padding that the JAX builder's abstract cell
    gives them."""
    mesh = sl.current_mesh()
    ranks = sl.axis_size(node_axes())
    if mesh is None or ranks == 1:
        return g
    e = g.src.shape[0]
    n_chunks = n_edge_chunks(e, cfg.edge_chunk)
    ranged = cfg.edge_layout == "dst_ranged" and n_chunks > 1
    if ranged and n_chunks % ranks:
        raise ValueError(
            f"{arch_id}: its {n_chunks} dst_ranged edge chunks do not fall "
            f"whole in the node blocks of the {_mesh_text(mesh)} ({ranks} "
            "ranks over the nodes): a chunk count that the node ranks "
            "divide is needed")
    n_pad = _pad_to(g.n_nodes, n_chunks if ranged else ranks)
    if abstract:
        return _resized(g, n_pad, (
            n_chunks * -(-e // n_chunks) if ranged else
            ranks * int(np.ceil(e / ranks * 1.15))
            if cfg.edge_layout == "partitioned" else _pad_to(e, ranks)))
    g = _pad_nodes(g, n_pad)
    if ranged:
        return _owner_buckets(g, n_chunks, -(-e // n_chunks), arch_id,
                              mesh)
    if cfg.edge_layout == "partitioned":
        return _owner_buckets(g, ranks)
    return _pad_edges(g, _pad_to(e, ranks))


def _pad_nodes(g: GraphBatch, n_pad: int) -> GraphBatch:
    """``g`` with ``n_pad`` nodes (see :func:`gnn_mesh_layout`)."""
    n, k = g.n_nodes, n_pad - g.n_nodes
    node_level = g.graph_ids is None

    def rows(t, fill):
        if t is None or not k:
            return t
        return torch.cat([t, t.new_full((k,) + tuple(t.shape[1:]), fill)])
    mask = g.train_mask
    if mask is None and node_level:
        mask = torch.ones(n, dtype=torch.bool, device=g.src.device)
    return dataclasses.replace(
        g, n_nodes=n_pad,
        src=torch.where(g.src == n, n_pad, g.src),
        dst=torch.where(g.dst == n, n_pad, g.dst),
        node_feat=rows(g.node_feat, 0),
        graph_ids=rows(g.graph_ids, g.n_graphs),
        labels=rows(g.labels, 0) if node_level else g.labels,
        train_mask=rows(mask, False))


def _pad_edges(g: GraphBatch, e_pad: int) -> GraphBatch:
    """``g`` with sentinel edges appended up to ``e_pad``."""
    k = e_pad - g.src.shape[0]
    if not k:
        return g
    sent = g.src.new_full((k,), g.n_nodes)
    ef = g.edge_feat
    if ef is not None:
        ef = torch.cat([ef, torch.from_numpy(stub_edge_feat(
            k, tuple(ef.shape[1:]))).to(ef.device, ef.dtype)])
    return dataclasses.replace(g, src=torch.cat([g.src, sent]),
                               dst=torch.cat([g.dst, sent]), edge_feat=ef)


def _owner_buckets(g: GraphBatch, n_buckets: int, cap: Optional[int] = None,
                   arch_id: str = "", mesh=None) -> GraphBatch:
    """``g``'s edges bucketed by destination into ``n_buckets`` equal
    node ranges (``n_nodes`` a multiple of ``n_buckets``), each bucket
    padded with sentinel edges to ``cap`` edges (default: the fullest
    bucket's count).  Edges into the sentinel add to no node and are
    dropped.  On the host, as ``bucket_edges_by_dst``."""
    n = g.n_nodes
    width = n // n_buckets
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    keep = np.flatnonzero(dst < n)
    bucket = dst[keep] // width
    counts = np.bincount(bucket, minlength=n_buckets)
    if cap is None:
        cap = max(int(counts.max()), 1)
    elif counts.max() > cap:
        raise ValueError(
            f"{arch_id}: a dst_ranged chunk of the padded graph takes "
            f"{int(counts.max())} edges, more than its {cap} slots, on the "
            f"{_mesh_text(mesh)}")
    order = keep[np.argsort(bucket, kind="stable")]
    slot = (np.repeat(np.arange(n_buckets) * cap, counts)
            + np.arange(order.shape[0])
            - np.repeat(np.cumsum(counts) - counts, counts))
    new_src = np.full(n_buckets * cap, n, np.int32)
    new_dst = np.full(n_buckets * cap, n, np.int32)
    new_src[slot], new_dst[slot] = src[order], dst[order]
    dev = g.src.device
    ef = g.edge_feat
    if ef is not None:
        feat = stub_edge_feat(n_buckets * cap, tuple(ef.shape[1:]))
        feat[slot] = ef.cpu().numpy()[order]
        ef = torch.from_numpy(feat).to(dev, ef.dtype)
    return dataclasses.replace(
        g, src=torch.from_numpy(new_src).to(dev, g.src.dtype),
        dst=torch.from_numpy(new_dst).to(dev, g.dst.dtype), edge_feat=ef)


def shard_train_cell(cell: Cell) -> Cell:
    """A world-1 GNN or recsys train cell, which holds its state whole,
    on this rank's blocks under the current rules, with its step and
    ``in_shardings``: the same cell as ``build_cell`` makes under them
    (whose keyed draw gives each rank its blocks of the same weights),
    cut from the cell's own state and batch, so a caller that holds a
    full-size cell lays it out without building it again.  Where nothing
    is cut (the replicated GNN parameters, a one-rank mesh) a block is
    the cell's own tensor: clone the state first to step both cells.

    A GNN cell's graph is laid out by :func:`gnn_mesh_layout` and cut to
    the rank's node and edge blocks.  Every step's graph is laid out the
    same way (a ``minibatch_lg`` block is drawn whole on every rank from
    the same seed, and each keeps its own blocks); a cell's one graph is
    laid out once.  A recsys train cell's tables are cut to the rank's
    row blocks and its batch to the rank's rows."""
    if (cell.family, cell.kind) == ("recsys", "train"):
        in_sh = _recsys_train_shardings(cell.meta["cfg"])
        return _recsys_rows(cell, local_blocks(cell.args[0], in_sh[0]),
                            in_sh)
    if cell.family != "gnn":
        raise ValueError(f"{cell.arch} {cell.shape}: shard_train_cell lays "
                         "out the GNN and recsys train cells")
    cfg = cell.meta["cfg"]
    state, graph = cell.args

    def layout(g):
        whole = gnn_mesh_layout(cell.arch, cfg, g,
                                cell.meta.get("abstract", False))
        sh = _gnn_batch_shardings(whole)
        return local_blocks(whole, sh), sh
    mine, batch_sh = layout(graph)
    repl = _replicated(state["params"])
    in_sh = ({"params": repl,
              "opt": OptState(m=repl, v=repl, count=sl.sharding_for())},
             batch_sh)
    whole_at = cell.batch_at

    def batch_at(step):
        g = whole_at(step)[0]
        return ((mine if g is graph else layout(g)[0]),)
    return dataclasses.replace(
        cell, args=(local_blocks(state, in_sh[0]), mine), batch_at=batch_at,
        in_shardings=in_sh)


def _gnn_batch_shardings(g: GraphBatch) -> GraphBatch:
    """The JAX cell's sharding of a graph batch: edges over "edges",
    node tensors over "nodes", a graph-level label replicated."""
    node_level = g.graph_ids is None

    def on(t, *names):
        return None if t is None else sl.sharding_for(*names)
    return dataclasses.replace(
        g, src=on(g.src, "edges"), dst=on(g.dst, "edges"),
        node_feat=on(g.node_feat, "nodes",
                     *([None] * (g.node_feat.dim() - 1))),
        edge_feat=on(g.edge_feat, "edges", None),
        graph_ids=on(g.graph_ids, "nodes"),
        labels=(on(g.labels, "nodes") if node_level
                else on(g.labels)),
        train_mask=on(g.train_mask, "nodes"))


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
    ``bag_sum``'s backward returns, taken as it is (no copy).  Under a
    mesh ``params`` are this rank's blocks (a row block of every table,
    the MLPs whole) and the inputs its data shard's rows; the loss is
    the whole batch's, and every gradient block, the MLPs' and the
    table's, is summed over the data axes that split the batch."""
    loss, grads = value_and_grad(
        lambda p: dlrm_mod.loss_fn(p, dense, sparse, labels, cfg), params)
    if sl.current_mesh() is not None:
        sl.reduce_grads(grads, _resolve(dlrm_mod.param_shardings(cfg)),
                        sl._live_axes("batch"))
    return loss, grads


def _dlrm_train_step(cfg: dlrm_mod.DLRMConfig):
    """The JAX DLRM train step: loss and grads, AdamW at lr 1e-3 with no
    weight decay (clip 1.0); in place.  Under a mesh, on this rank's
    blocks, clipped to the whole model's norm (the tables' squares
    summed over ``model``)."""
    def step(state, dense, sparse, labels):
        loss, grads = dlrm_value_and_grad(state["params"], dense, sparse,
                                          labels, cfg)
        shardings = (_resolve(dlrm_mod.param_shardings(cfg))
                     if sl.current_mesh() is not None else None)
        _, state["opt"], gnorm = adamw_update(state["params"], grads,
                                              state["opt"], 1e-3,
                                              weight_decay=0.0,
                                              shardings=shardings)
        return state, {"loss": loss, "gnorm": gnorm}
    return step


def _recsys_train_shardings(cfg: dlrm_mod.DLRMConfig):
    """A recsys train cell's ``in_shardings`` under the current rules:
    the tables' rows over ``model``, the batch over the data axes."""
    psh = _resolve(dlrm_mod.param_shardings(cfg))
    rows = sl.sharding_for("batch", None)
    return ({"params": psh,
             "opt": OptState(m=psh, v=psh, count=sl.sharding_for())},
            rows, rows, sl.sharding_for("batch"))


def _recsys_rows(cell: Cell, state, in_sh) -> Cell:
    """``cell`` (a recsys train cell with its batch whole) on ``state``,
    this rank's blocks, with its batch and every later step's cut to
    the rank's rows under ``in_sh``."""
    whole_at = cell.batch_at
    return dataclasses.replace(
        cell, args=(state,) + local_blocks(cell.args[1:], in_sh[1:]),
        in_shardings=in_sh,
        batch_at=lambda step: local_blocks(whole_at(step), in_sh[1:]))


def _build_recsys_cell(arch_id, shape_name, mod, smoke, device, batch,
                       abstract=False, draw=True):
    cfg = mod.smoke_config() if smoke else mod.CONFIG
    sp = dict(SHAPE_PARAMS["recsys"][shape_name])
    kind = sp["kind"]
    full_b = 8 if smoke else sp.get("batch", 1)
    b = full_b if batch is None else batch
    n_cand = 1024 if smoke else sp.get("n_candidates", 0)
    meta = {"cfg": cfg, "batch": b}
    if b != full_b:
        meta["reduced"] = {"batch": [full_b, b]}
    params = _init(dlrm_mod, cfg, device, abstract, draw)
    psh = (_resolve(dlrm_mod.param_shardings(cfg))
           if sl.current_rules() is not None else None)
    rng = np.random.default_rng(SEED)
    if abstract:
        dense, sparse = _empty(device, ((b, cfg.n_dense), torch.float32),
                               ((b, cfg.n_sparse), torch.int32))
    else:
        dense = torch.from_numpy(
            rng.normal(size=(b, cfg.n_dense)).astype(np.float32)).to(device)
        sparse = torch.from_numpy(rng.integers(
            0, cfg.vocab_per_table, (b, cfg.n_sparse)).astype(
                np.int32)).to(device)
    if kind == "train":
        if abstract:
            batch_args = (dense, sparse) + _empty(device, ((b,), torch.int32))
            batch_at = lambda step: batch_args  # noqa: E731
        else:
            stream = RecsysStream(batch=b, n_dense=cfg.n_dense,
                                  n_sparse=cfg.n_sparse,
                                  vocab=cfg.vocab_per_table, seed=SEED)
            if smoke:   # the JAX smoke cell's inputs
                labels = torch.from_numpy(
                    rng.integers(0, 2, b).astype(np.int32)).to(device)
                batch_args = (dense, sparse, labels)
            else:       # Zipf ids, as training traffic has
                batch_args = _on(stream.batch_at(0), device)
            batch_at = lambda step: _on(stream.batch_at(step),  # noqa: E731
                                        device)
        meta["data"] = "RecsysStream"
        # under rules the state is this rank's blocks already (the keyed
        # draw, and m and v zeros at block size); the batch is cut
        state = {"params": params, "opt": adamw_init(params)}
        cell = Cell(arch_id, shape_name, kind, "recsys",
                    _dlrm_train_step(cfg), (state,) + batch_args,
                    _dlrm_flops(cfg, kind, b), meta, batch_at=batch_at)
        return cell if psh is None else _recsys_rows(
            cell, state, _recsys_train_shardings(cfg))
    if kind == "serve":
        args = (params, dense, sparse)
        in_sh = None
        if psh is not None:
            in_sh = (psh, sl.sharding_for("batch", None),
                     sl.sharding_for("batch", None))
            args = (params,) + local_blocks(args[1:], in_sh[1:])
        return Cell(arch_id, shape_name, kind, "recsys",
                    functools.partial(dlrm_mod.forward, cfg=cfg), args,
                    _dlrm_flops(cfg, kind, b), meta, in_shardings=in_sh)
    # the candidates split evenly over the data axes
    n_cand = _pad_to(n_cand, sl.axis_size(sl._live_axes("cand")))
    cand = (_empty(device, ((n_cand,), torch.int32))[0] if abstract else
            torch.from_numpy(rng.integers(
                0, cfg.vocab_per_table, n_cand).astype(np.int32)).to(device))
    meta["n_candidates"] = n_cand
    args = (params, dense[:1], sparse[:1], cand)
    in_sh = None
    if psh is not None:
        in_sh = (psh, sl.sharding_for(None, None),
                 sl.sharding_for(None, None), sl.sharding_for("cand"))
        args = (params,) + local_blocks(args[1:], in_sh[1:])
    return Cell(arch_id, shape_name, kind, "recsys",
                functools.partial(dlrm_mod.retrieval_scores, cfg=cfg),
                args, _dlrm_flops(cfg, kind, 1, n_cand), meta,
                in_shardings=in_sh)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, smoke: bool = False,
               device=None, batch: Optional[int] = None,
               layers: Optional[int] = None, variant: str = "base",
               abstract: bool = False, draw: bool = True) -> Cell:
    """The cell ``(arch_id, shape_name)`` with concrete tensors on
    ``device`` (default ``cuda``; raises without a card unless given
    ``"cpu"``).  ``batch`` overrides the assigned batch of an LM or DLRM
    cell and ``layers`` an LM's depth (cuts, recorded in
    ``meta["reduced"]``); ``variant="opt"`` picks an LM's optimized
    training (:func:`lm_cell_config`) or a GNN cell's bucketed edge
    layouts.  Weights and inputs come from seed 0.  Under axis rules
    each rank draws only its blocks of the weights (the module's
    docstring).  ``draw=False``: the state (weights, and a train cell's
    AdamW state) is left uninitialised for a restore to fill (the train
    CLI's resume); nothing is drawn.

    ``abstract=True``: the same cell on fake tensors (the module's
    docstring), built and to be run under ``meta["fake_mode"]`` (the
    active ``FakeTensorMode``, else a new one); ``device`` is ignored,
    and no card is needed."""
    if abstract:
        mode = detect_fake_mode() or FakeTensorMode(
            allow_non_fake_inputs=True)
        with mode:
            cell = _build(arch_id, shape_name, smoke, fake_device(), batch,
                          layers, variant, True, False)
        cell.meta.update(fake_mode=mode, abstract=True)
        return cell
    return _build(arch_id, shape_name, smoke, resolve_device(device), batch,
                  layers, variant, False, draw)


def _build(arch_id, shape_name, smoke, device, batch, layers, variant,
           abstract, draw) -> Cell:
    mod = get_arch(arch_id)
    skip = getattr(mod, "SKIP_SHAPES", {})
    if shape_name in skip:
        raise ValueError(f"{arch_id} does not run {shape_name}: "
                         f"{skip[shape_name]}")
    if variant not in ("base", "opt"):
        raise ValueError(f"variant must be 'base' or 'opt', got {variant!r}")
    if variant != "base" and mod.FAMILY not in ("lm", "gnn"):
        raise NotImplementedError(f"{arch_id}: only the LM and GNN cells "
                                  "have an 'opt' variant")
    if mod.FAMILY == "lm":
        return _build_lm_cell(arch_id, shape_name, smoke, device, batch,
                              layers, variant, abstract, draw)
    if layers is not None:
        raise ValueError(f"{arch_id}: layers= cuts an LM's depth only")
    if mod.FAMILY == "gnn":
        if batch is not None:
            raise ValueError(f"{arch_id}: batch= cuts an LM or DLRM batch "
                             "only")
        return _build_gnn_cell(arch_id, shape_name, mod, smoke, device,
                               variant, abstract, draw)
    return _build_recsys_cell(arch_id, shape_name, mod, smoke, device, batch,
                              abstract, draw)
