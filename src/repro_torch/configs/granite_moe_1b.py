"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L d1024 16H (GQA kv=8) MoE 32e top-8 d_ff=512 v49155.

The 49155-entry vocab is padded to 49408 (next multiple of 256) so the
embedding/logit matrices shard evenly on the 16-way model axis; labels
never index the pad rows.
"""
import dataclasses

from ..models.layers import MoEConfig
from ..models.transformer import TransformerConfig

FAMILY = "lm"

VOCAB_TRUE = 49155

CONFIG = TransformerConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_ff=0, vocab=49408, head_dim=64, rope_theta=1e4,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512),
    tie_embeddings=True,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
        head_dim=16, attn_chunk=32, loss_chunk=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32))
