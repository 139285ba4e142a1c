"""GIN (Xu et al., arXiv:1810.00826): 5 layers, sum aggregator, learnable ε.

h_v' = MLP((1 + ε) h_v + Σ_{u∈N(v)} h_u); graph-level tasks read out with a
sum pool per layer (jumping knowledge, as in the paper's TU setup).  The
JAX package's ``models/gnn/gin.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ...device import resolve_device
from .common import (GraphBatch, chunked_scatter_sum, edge_count, extend,
                     gather_nodes, gather_scatter_sum, graph_readout, mlp,
                     mlp_init, n_edge_chunks, once, partitioned_aggregate,
                     take)
from .gcn import masked_nll


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_in: int = 64
    d_hidden: int = 64
    n_classes: int = 2
    node_level: bool = False      # node classification (full-graph shapes)
    edge_chunk: int = 0
    edge_layout: str = "arbitrary"   # | "partitioned" (see gcn.py)
    dtype: Any = torch.float32


def init_params(cfg: GINConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Per layer a 2-layer MLP and ε = 0, then the JK head, from
    ``generator`` on ``device`` (default ``cuda``; default seed 0)."""
    device = resolve_device(device)
    gen = (torch.Generator(device=device).manual_seed(0)
           if generator is None else generator)
    layers = []
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "mlp": mlp_init(gen, [d_prev, cfg.d_hidden, cfg.d_hidden],
                            cfg.dtype, device),
            "eps": torch.zeros((), dtype=cfg.dtype, device=device),
        })
        d_prev = cfg.d_hidden
    # per-layer readout heads (JK): the hidden width of every layer
    head = mlp_init(gen, [cfg.d_hidden * cfg.n_layers, cfg.n_classes],
                    cfg.dtype, device)
    return {"layers": layers, "head": head}


def forward(params, g: GraphBatch, cfg: GINConfig) -> torch.Tensor:
    """Logits of the nodes (node level; under a mesh of this rank's node
    block) or of the graphs (whole on every rank: the readout sums the
    blocks, and the head after it counts its gradient once, ``once``)."""
    n = g.n_nodes
    x = g.node_feat.to(cfg.dtype)
    n_chunks = n_edge_chunks(edge_count(g), cfg.edge_chunk)
    reps = []
    for lp in params["layers"]:
        if cfg.edge_layout == "partitioned":
            agg = partitioned_aggregate(
                x, (g.src, g.dst), lambda xf, s, d: (take(xf, s), d),
                n, x.shape[1:], x.dtype, n_chunks=n_chunks)
        elif n_chunks == 1:
            agg = gather_scatter_sum(x, g.src, g.dst, n)
        else:
            # xe bound now: backward re-runs the chunk after the loop
            # has moved on to the next layer's x
            agg = chunked_scatter_sum(
                lambda s, d, xe=extend(gather_nodes(x)): (
                    xe.index_select(0, s), d),
                n_chunks, (g.src, g.dst), n, x.shape[1:], x.dtype)
        x = mlp((1.0 + lp["eps"]) * x + agg, lp["mlp"])
        reps.append(x)
    h = torch.cat(reps, dim=-1)
    if cfg.node_level:
        return mlp(h, [params["head"][0]])
    pooled = graph_readout(h, g.graph_ids, g.n_graphs, op="sum")
    return mlp(pooled, [once(params["head"][0])])


def loss_fn(params, g: GraphBatch, cfg: GINConfig) -> torch.Tensor:
    logits = forward(params, g, cfg)
    if cfg.node_level and g.train_mask is not None:
        return masked_nll(logits, g.labels, g.train_mask)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, g.labels.long()[:, None])[:, 0].mean()
