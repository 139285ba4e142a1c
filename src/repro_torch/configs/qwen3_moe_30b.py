"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]:
48L d2048 32H (GQA kv=4) MoE 128e top-8 d_ff=768 v151936."""
import dataclasses

from ..models.layers import MoEConfig
from ..models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=0, vocab=151936, head_dim=64, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    tie_embeddings=False,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
        head_dim=16, attn_chunk=32, loss_chunk=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32))
