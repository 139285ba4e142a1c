"""schnet [arXiv:1706.08566]: 3 interactions d64 rbf=300 cutoff=10."""
import dataclasses

from ..models.gnn.schnet import SchNetConfig

FAMILY = "gnn"

CONFIG = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                      n_rbf=300, cutoff=10.0)

SKIP_SHAPES = {}


def smoke_config():
    return dataclasses.replace(CONFIG, n_interactions=2, d_hidden=16,
                               n_rbf=32)
