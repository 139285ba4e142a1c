"""equiformer-v2 [arXiv:2306.12059]: 12L d128 l_max=6 m_max=2 8H eSCN."""
import dataclasses

from ..models.gnn.equiformer_v2 import EquiformerV2Config

FAMILY = "gnn"

CONFIG = EquiformerV2Config(name="equiformer-v2", n_layers=12, d_hidden=128,
                            l_max=6, m_max=2, n_heads=8)

SKIP_SHAPES = {}


def smoke_config():
    return dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, l_max=2,
                               m_max=1, n_heads=2, n_rbf=16)
