"""gin-tu [arXiv:1810.00826]: 5L d64 sum-agg learnable eps."""
import dataclasses

from ..models.gnn.gin import GINConfig

FAMILY = "gnn"

CONFIG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64)

SKIP_SHAPES = {}


def smoke_config():
    return dataclasses.replace(CONFIG, n_layers=2, d_hidden=16)
