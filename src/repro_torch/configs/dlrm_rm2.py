"""dlrm-rm2 [arXiv:1906.00091]: 13 dense / 26 sparse, d64 embeddings,
bot 13-512-256-64, top 512-512-256-1, dot interaction."""
import dataclasses

from ..models.dlrm import DLRMConfig

FAMILY = "recsys"

CONFIG = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                    vocab_per_table=1_000_000,
                    bot_mlp=(13, 512, 256, 64),
                    top_mlp=(512, 512, 256, 1), interaction="dot")

SKIP_SHAPES = {}


def smoke_config():
    return dataclasses.replace(CONFIG, vocab_per_table=1000)
