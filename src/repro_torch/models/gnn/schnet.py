"""SchNet (Schütt et al., arXiv:1706.08566): continuous-filter convolutions.

Interaction block: x → Dense → (gather src) ⊙ W(rbf(d)) → scatter-sum dst →
Dense → ssp → Dense → residual, with rbf = 300 Gaussians on [0, cutoff].
The geometry frontend is a stub: edge distances (or vectors) arrive
precomputed in ``GraphBatch.edge_feat``.  The JAX package's
``models/gnn/schnet.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...device import resolve_device
from ..common import dense_init
from .common import (GraphBatch, chunked_scatter_sum, edge_count, extend,
                     gather_nodes, graph_readout, mlp, mlp_init,
                     n_edge_chunks, partitioned_aggregate, scatter_sum)
from .gcn import masked_nll

LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(x) - log 2``, spelled as JAX computes softplus
    (``logaddexp(x, 0)``): ``F.softplus`` returns ``x`` itself above its
    threshold of 20."""
    return torch.logaddexp(x, x.new_zeros(())) - LOG2


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_in: int = 0              # 0 => integer atom types -> embedding
    n_atom_types: int = 100
    n_targets: int = 1         # energy regression
    edge_chunk: int = 0
    edge_layout: str = "arbitrary"   # | "partitioned" (see gcn.py)
    dtype: Any = torch.float32


def init_params(cfg: SchNetConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """The JAX module's tree and laws, from ``generator`` on ``device``
    (default ``cuda``; default seed 0)."""
    device = resolve_device(device)
    gen = (torch.Generator(device=device).manual_seed(0)
           if generator is None else generator)
    dense = functools.partial(dense_init, gen, dtype=cfg.dtype, device=device)
    c = cfg.d_hidden
    params: Dict[str, Any] = {}
    if cfg.d_in == 0:
        params["embed"] = dense((cfg.n_atom_types, c))
    else:
        params["embed_w"] = dense((cfg.d_in, c))
    params["interactions"] = [{
        "filter": mlp_init(gen, [cfg.n_rbf, c, c], cfg.dtype, device),
        "in_w": dense((c, c)),
        "out": mlp_init(gen, [c, c, c], cfg.dtype, device),
    } for _ in range(cfg.n_interactions)]
    params["head"] = mlp_init(gen, [c, c // 2, cfg.n_targets], cfg.dtype,
                              device)
    return params


@functools.lru_cache(maxsize=16)
def rbf_centers(n_rbf: int, cutoff: float, device: torch.device
                ) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf)`` in f32, bit for bit: XLA folds
    its ``iota / (n - 1)`` into ``(cutoff * (1 / (n - 1))) * iota`` and
    ends on ``cutoff`` (``torch.linspace`` rounds ~40% of them
    otherwise).  Made on the host once a device."""
    if n_rbf == 1:
        c = np.zeros(1, np.float32)
    else:
        step = np.float32(cutoff) * (np.float32(1) / np.float32(n_rbf - 1))
        c = np.append(step * np.arange(n_rbf - 1, dtype=np.float32),
                      np.float32(cutoff))
    return torch.from_numpy(c.astype(np.float32)).to(device)


def rbf_expand(dist: torch.Tensor, cfg) -> torch.Tensor:
    centers = rbf_centers(cfg.n_rbf, float(cfg.cutoff), dist.device)
    gamma = (cfg.n_rbf / cfg.cutoff) ** 2 * 0.5
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def edge_distances(g: GraphBatch) -> torch.Tensor:
    """[E] f32: the norms of 3-vector edge features, or the features."""
    if g.edge_feat.dim() == 2 and g.edge_feat.shape[-1] == 3:
        v = g.edge_feat.float()
        return torch.sqrt(torch.clamp(torch.sum(v ** 2, -1), min=1e-12))
    return g.edge_feat.reshape(-1).float()


def _edge_filter(dd: torch.Tensor, lp, cfg: SchNetConfig) -> torch.Tensor:
    """The continuous filter W(rbf(d)) of an interaction, with its cosine
    cutoff envelope: [e, d_hidden]."""
    rbf = rbf_expand(dd, cfg)
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dd / cfg.cutoff, 0, 1))
                 + 1.0)
    return mlp(rbf, lp["filter"], act=shifted_softplus) * env[:, None]


def forward(params, g: GraphBatch, cfg: SchNetConfig) -> torch.Tensor:
    n = g.n_nodes
    if cfg.d_in == 0:
        x = params["embed"].index_select(0, g.node_feat.long())
    else:
        x = g.node_feat.to(cfg.dtype) @ params["embed_w"]
    dist = edge_distances(g)
    n_chunks = n_edge_chunks(edge_count(g), cfg.edge_chunk)
    for lp in params["interactions"]:
        h = x @ lp["in_w"]
        # the edge functions bind this interaction's weights and features
        # now: backward re-runs a chunk after the loop has moved on
        filt = functools.partial(_edge_filter, lp=lp, cfg=cfg)
        if cfg.edge_layout == "partitioned":
            agg = partitioned_aggregate(
                h, (g.src, g.dst, dist),
                lambda hf, s, d, dd, filt=filt: (
                    extend(hf).index_select(0, s) * filt(dd), d),
                n, (cfg.d_hidden,), h.dtype, n_chunks=n_chunks)
        else:
            def edge_op(s, d, dd, he=extend(gather_nodes(h)), filt=filt):
                return he.index_select(0, s) * filt(dd), d

            if n_chunks == 1:
                msgs, _ = edge_op(g.src, g.dst, dist)
                agg = scatter_sum(msgs, g.dst, n)
            else:
                agg = chunked_scatter_sum(edge_op, n_chunks,
                                          (g.src, g.dst, dist), n,
                                          (cfg.d_hidden,), h.dtype)
        x = x + mlp(agg, lp["out"], act=shifted_softplus)
    return x


def predict(params, g: GraphBatch, cfg: SchNetConfig) -> torch.Tensor:
    x = forward(params, g, cfg)
    atomwise = mlp(x, params["head"], act=shifted_softplus)
    if g.graph_ids is None:
        return atomwise
    return graph_readout(atomwise, g.graph_ids, g.n_graphs, op="sum")


def regression_or_nll(pred: torch.Tensor, g: GraphBatch) -> torch.Tensor:
    """Integer labels: classification (masked on a node-level graph);
    float labels: mean squared error (the SchNet and Equiformer loss)."""
    if g.labels.dtype in (torch.int32, torch.int64):  # classification cells
        if g.train_mask is not None and g.graph_ids is None:
            return masked_nll(pred, g.labels, g.train_mask)
        logp = torch.log_softmax(pred, dim=-1)
        return -torch.gather(logp, -1, g.labels.long()[:, None])[:, 0].mean()
    target = g.labels.float().reshape(pred.shape)
    return torch.mean((pred - target) ** 2)


def loss_fn(params, g: GraphBatch, cfg: SchNetConfig) -> torch.Tensor:
    return regression_or_nll(predict(params, g, cfg), g)
