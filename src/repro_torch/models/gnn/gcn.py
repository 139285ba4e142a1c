"""GCN (Kipf & Welling, arXiv:1609.02907): 2-layer, symmetric-normalized.

out = Ã ReLU(Ã X W1) W2,  Ã = D^-1/2 (A + I) D^-1/2 — expressed as
gather→scale→scatter over the edge list, the self loop as the identity
term (the JAX package's ``models/gnn/gcn.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ...device import resolve_device
from .common import (GraphBatch, chunked_scatter_sum, degrees, edge_count,
                     extend, gather_nodes, gather_scatter_sum, masked_mean,
                     mlp_init, n_edge_chunks, partitioned_aggregate, take)


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"
    aggregator: str = "mean"   # paper config: sym-norm mean
    edge_chunk: int = 0        # >0: max edges per chunk (big graphs)
    # "arbitrary" | "partitioned" (edges pre-bucketed by dst owner)
    edge_layout: str = "arbitrary"
    dtype: Any = torch.float32


def init_params(cfg: GCNConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Normal x fan_in^-0.5 weights, zero biases, from ``generator`` on
    ``device`` (default ``cuda``; default seed 0)."""
    device = resolve_device(device)
    gen = (torch.Generator(device=device).manual_seed(0)
           if generator is None else generator)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": mlp_init(gen, dims, cfg.dtype, device)}


def forward(params, g: GraphBatch, cfg: GCNConfig) -> torch.Tensor:
    """Logits of the nodes (under a mesh, of this rank's node block:
    ``common``'s primitives run on blocks, and the norm's ``inv_sqrt``
    is gathered whole for the edge endpoints)."""
    n = g.n_nodes
    deg = degrees(g.dst, n) + 1.0                      # +1: self loop
    inv_sqrt = torch.rsqrt(deg)
    inv_e = extend(gather_nodes(inv_sqrt))
    coef = inv_e.index_select(0, g.src) * inv_e.index_select(0, g.dst)
    x = g.node_feat.to(cfg.dtype)
    n_chunks = n_edge_chunks(edge_count(g), cfg.edge_chunk)
    for i, (w, b) in enumerate(params["layers"]):
        x = x @ w                                       # transform first:
        if cfg.edge_layout == "partitioned":            # smaller SpMM width
            agg = partitioned_aggregate(
                x, (g.src, g.dst, coef),
                lambda xf, s, d, c: (take(xf, s) * c[:, None], d),
                n, x.shape[1:], x.dtype, n_chunks=n_chunks)
        elif n_chunks == 1:
            agg = gather_scatter_sum(x, g.src, g.dst, n, edge_weight=coef)
        else:
            # xe bound now: backward re-runs the chunk after the loop
            # has moved on to the next layer's x
            agg = chunked_scatter_sum(
                lambda s, d, c, xe=extend(gather_nodes(x)): (
                    xe.index_select(0, s) * c[:, None], d),
                n_chunks, (g.src, g.dst, coef), n, x.shape[1:], x.dtype)
        x = agg + x * inv_sqrt[:, None] ** 2 + b        # self-loop term
        if i < len(params["layers"]) - 1:
            x = torch.relu(x)
    return x


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the rows where ``mask`` holds
    (at least 1 in the denominator; under a mesh over every rank's node
    block, :func:`masked_mean`)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return masked_mean(nll, mask)


def loss_fn(params, g: GraphBatch, cfg: GCNConfig) -> torch.Tensor:
    logits = forward(params, g, cfg)
    mask = (g.train_mask if g.train_mask is not None
            else torch.ones(logits.shape[0], dtype=torch.bool,
                            device=logits.device))
    return masked_nll(logits, g.labels, mask)
