"""DLRM (Naumov et al., arXiv:1906.00091), RM2 configuration.

13 dense features -> bottom MLP (13-512-256-64); 26 categorical features
-> per-table embedding lookup (the hot path); dot-product feature
interaction over the 27 resulting vectors; top MLP (512-512-256-1) -> CTR
logit.  The JAX package's ``models/dlrm.py``: every lookup goes through
the hand-written ``bag_sum`` kernel, which gathers the rows itself, and
the tables' gradient through its hand-written backward
(``kernels/embedding_bag``, a ``torch.autograd.Function``).  The 26
tables are one ``[26, V, D]`` tensor; a forward pass is one ``bag_sum``
launch over its ``[26*V, D]`` view, a backward one ``bag_sum_backward``
launch.

Under an active mesh (``shardlib.axis_rules``) the tables are
**row-sharded over the model axis** and each rank holds its ``[26, V_l,
D]`` block: a lookup runs ``bag_sum`` on the rank's rows (ids shifted by
``axis_index * V_l``; an id outside them gives a zero row) and one
``psum`` joins the ranks, never an all-gather of the table.  Its
backward passes the whole cotangent to every rank's lookup, whose
``bag_sum_backward`` fills the gradient of the rank's rows alone (an id
sent past the end adds to none).  A train step's loss is the whole
batch's on every rank (:func:`loss_fn`).

``retrieval_cand`` scores one query against 10^6 candidates as a
(sharded) matvec, a local ``topk``, an all-gather of the winners over
the data axes and a final ``topk``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import shardlib as sl
from ..device import resolve_device
from ..kernels.embedding_bag import bag_sum
from ..shardlib import P
from . import init
from .common import mlp, mlp_init

TP = "model_dim"
DP = "batch"


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_table: int = 1_000_000
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    interaction: str = "dot"
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.interaction != "dot":
            raise ValueError(f"DLRMConfig: only the dot interaction is "
                             f"ported, got {self.interaction!r}")

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    def param_count(self) -> int:
        emb = self.n_sparse * self.vocab_per_table * self.embed_dim
        bot = sum(self.bot_mlp[i] * self.bot_mlp[i + 1]
                  for i in range(len(self.bot_mlp) - 1))
        d_top_in = self.n_interactions + self.bot_mlp[-1]
        dims = (d_top_in,) + self.top_mlp
        top = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return emb + bot + top


def init_params(cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
                device=None, shardings=None, draw: bool = True
                ) -> Dict[str, Any]:
    """Tables uniform in +-V^-0.5 and MLPs normal x fan_in^-0.5 (the JAX
    law) on ``device`` (default ``cuda``).  Without a ``generator``: the
    keyed draw (``models/init.py``), each leaf keyed by its path
    (``tables``, ``bot/0/0``), the tables tiled along their rows, and
    this rank's block under its ``NamedSharding`` in ``shardings`` (a
    tree like :func:`param_shardings`'s; None: whole leaves);
    ``draw=False`` leaves the blocks uninitialised.  With a
    ``generator`` (it must live on ``device``): drawn from it in
    sequence, the tables in place, so the 6.66 GB of rm2 are made on the
    card with no copy."""
    device = resolve_device(device)
    d_top_in = cfg.n_interactions + cfg.bot_mlp[-1]
    shape = (cfg.n_sparse, cfg.vocab_per_table, cfg.embed_dim)
    scale = cfg.vocab_per_table ** -0.5
    if generator is None:
        sh = shardings or {}
        return {
            "tables": init.keyed("tables", shape,
                                 param_shardings(cfg)["tables"], "uniform",
                                 scale, cfg.dtype, device, sh.get("tables"),
                                 draw=draw),
            "bot": mlp_init(None, list(cfg.bot_mlp), cfg.dtype, device,
                            path="bot", shardings=sh.get("bot"), draw=draw),
            "top": mlp_init(None, [d_top_in] + list(cfg.top_mlp), cfg.dtype,
                            device, path="top", shardings=sh.get("top"),
                            draw=draw),
        }
    tables = torch.empty(shape, dtype=cfg.dtype, device=device)
    tables.uniform_(-scale, scale, generator=generator)
    return {
        "tables": tables,
        "bot": mlp_init(generator, list(cfg.bot_mlp), cfg.dtype, device),
        "top": mlp_init(generator, [d_top_in] + list(cfg.top_mlp), cfg.dtype,
                        device),
    }


def param_shardings(cfg: DLRMConfig):
    """Logical axes of the parameters (lists group each layer's (W, b))."""
    return {"tables": (None, "rows", None),
            "bot": [[(None, None), (None,)]
                    for _ in range(len(cfg.bot_mlp) - 1)],
            "top": [[(None, None), (None,)]
                    for _ in range(len(cfg.top_mlp))]}


# ---------------------------------------------------------------------------
# EmbeddingBag (single- and multi-hot), row-sharded
# ---------------------------------------------------------------------------

def embedding_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [T, V, D] (under a mesh, this rank's [T, V_l, D] row
    block); ids [B, T] -> [B, T, D] (row ``ids[b, t]`` of table t).
    Each rank resolves the ids in its row range; one ``psum`` joins."""
    if sl.current_mesh() is None:
        return _lookup(tables, ids, 0)
    tp, dp = sl._live_axes(TP), sl._live_axes(DP)
    dpa, tpa = (dp if dp else None), (tp[0] if tp else None)
    fn = sl.maybe_shard_map(
        lambda tab, i: sl.psum(
            _lookup(tab, i, sl.axis_index(tp) * tab.shape[1]), tp),
        in_specs=(P(None, tpa, None), P(dpa, None)),
        out_specs=P(dpa, None, None))
    return fn(tables, ids)


def _lookup(tables: torch.Tensor, ids: torch.Tensor, lo: int
            ) -> torch.Tensor:
    """Rows ``ids - lo`` of the [T, V_l, D] block: one ``bag_sum``
    launch over its ``[T*V_l, D]`` view, with ids offset by ``t*V_l``;
    an id outside ``[lo, lo + V_l)`` gives a zero row, as the JAX
    lookup's range mask does."""
    t, v, d = tables.shape
    b = ids.shape[0]
    ids = ids.long() - lo
    ok = (ids >= 0) & (ids < v)
    flat = ids + torch.arange(t, device=ids.device) * v
    flat = torch.where(ok, flat, t * v)          # past the end: a zero row
    ones = torch.ones((b * t, 1), dtype=tables.dtype, device=tables.device)
    out = bag_sum(tables.view(t * v, d), flat.to(torch.int32).view(b * t, 1),
                  ones)
    return out.view(b, t, d)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, n_bags: int,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot EmbeddingBag over one table: ids [L], offsets
    [n_bags+1]; bag b pools rows ``ids[offsets[b]:offsets[b+1]]``.

    The bags are padded to ``[n_bags, max_len]`` with a validity mask and
    summed by one ``bag_sum`` launch; ``mode="mean"`` divides by the bag
    size (at least 1).
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode must be 'sum' or 'mean', got "
                         f"{mode!r}")
    dev = ids.device
    offsets = offsets.long()
    lengths = offsets[1:n_bags + 1] - offsets[:n_bags]
    max_len = int(lengths.max()) if n_bags else 0
    slot = torch.arange(max_len, device=dev)
    mask = slot[None, :] < lengths[:, None]
    pos = (offsets[:n_bags, None] + slot[None, :]).clamp(0, ids.shape[0])
    ids_ext = torch.cat([ids.to(torch.int32), ids.new_zeros(1, dtype=torch.int32)])
    padded = torch.where(mask, ids_ext[pos], 0).to(torch.int32)
    out = bag_sum(table, padded, mask)
    if mode == "mean":
        cnt = torch.clamp(lengths.to(out.dtype), min=1.0)
        out = out / cnt[:, None]
    return out


# ---------------------------------------------------------------------------
# Forward / loss / retrieval
# ---------------------------------------------------------------------------

def forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """dense [B, 13] f32, sparse_ids [B, 26] int -> CTR logits [B]."""
    bot = mlp(dense.to(cfg.dtype), params["bot"])             # [B, 64]
    emb = embedding_lookup(params["tables"], sparse_ids)      # [B, 26, 64]
    z = torch.cat([bot[:, None, :], emb], dim=1)              # [B, 27, 64]
    zz = torch.bmm(z, z.transpose(1, 2))                      # [B, 27, 27]
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=z.device)
    inter = zz[:, iu, ju]                                     # [B, 351]
    top_in = torch.cat([bot, inter], dim=-1)
    return mlp(top_in, params["top"])[:, 0]


def loss_fn(params, dense: torch.Tensor, sparse_ids: torch.Tensor,
            labels: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits, in the JAX formula's
    stable form ``max(l, 0) - l * y + log1p(exp(-|l|))`` (``torch.maximum``
    splits a tie's gradient in half, as ``jnp.maximum`` does).  The
    table's gradient comes from ``bag_sum``'s backward.  Under a mesh
    whose data axes split the batch, the whole batch's mean on every
    rank: the mean of the data shards' equal-sized means (a ``psum``
    over those axes, divided by their size)."""
    logit = forward(params, dense, sparse_ids, cfg)
    y = labels.to(torch.float32)
    mean = torch.mean(torch.maximum(logit, logit.new_zeros(())) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))
    if sl.current_mesh() is None:
        return mean
    dp = sl._live_axes(DP)
    return sl.psum(mean, dp) / sl.axis_size(dp)


def user_vector(params, dense: torch.Tensor, sparse_ids: torch.Tensor,
                cfg: DLRMConfig) -> torch.Tensor:
    """Query-side representation for retrieval: bottom-MLP out + pooled
    sparse embeddings (a two-tower view of the same parameters)."""
    bot = mlp(dense.to(cfg.dtype), params["bot"])
    emb = embedding_lookup(params["tables"], sparse_ids)
    return bot + emb.sum(dim=1)


def retrieval_scores(params, dense: torch.Tensor, sparse_ids: torch.Tensor,
                     cand_ids: torch.Tensor, cfg: DLRMConfig,
                     top_k: int = 128):
    """Score 1 query against N candidates (table-0 rows); return the
    top-k (scores, candidate ids), best first.  Candidates outside the
    table score 0, as the JAX version's range mask gives.

    Under a mesh, candidates are split over the data axes and table rows
    over the model axis: each rank scores its candidates on its rows
    (zeros elsewhere), a ``psum`` of the partial scores over the model
    axis completes them, and a local top-k, an ``all_gather`` over the
    data axes and a final top-k merge the winners."""
    u = user_vector(params, dense, sparse_ids, cfg)[0]        # [D]
    tp, dp = sl._live_axes(TP), sl._live_axes(DP)

    def inner(u, cand_l, table0_l):
        v_l = table0_l.shape[0]
        local = cand_l.long() - sl.axis_index(tp) * v_l
        ok = (local >= 0) & (local < v_l)
        rows = table0_l[local.clamp(0, v_l - 1)]
        rows = rows * ok[:, None].to(rows.dtype)
        scores = sl.psum(rows @ u, tp)                        # [N_l]
        vals, idx = torch.topk(scores, min(top_k, scores.shape[0]))
        vals = sl.all_gather(vals, dp, axis=0)
        ids = sl.all_gather(cand_l[idx], dp, axis=0)
        best, at = torch.topk(vals, min(top_k, vals.shape[0]))
        return best, ids[at]

    if sl.current_mesh() is None:
        return inner(u, cand_ids, params["tables"][0])
    dpa, tpa = (dp if dp else None), (tp[0] if tp else None)
    fn = sl.maybe_shard_map(inner, in_specs=(P(), P(dpa), P(tpa, None)),
                            out_specs=(P(), P()))
    return fn(u, cand_ids, params["tables"][0])
