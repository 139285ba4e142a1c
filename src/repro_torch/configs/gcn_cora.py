"""gcn-cora [arXiv:1609.02907]: 2L d16 mean-agg sym-norm."""
import dataclasses

from ..models.gnn.gcn import GCNConfig

FAMILY = "gnn"

CONFIG = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, norm="sym",
                   aggregator="mean")

SKIP_SHAPES = {}


def smoke_config():
    return dataclasses.replace(CONFIG, d_hidden=8)
