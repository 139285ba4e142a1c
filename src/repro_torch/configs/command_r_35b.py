"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01]:
40L d8192 64H (GQA kv=8) ff22528 v256000 — GQA, no-bias."""
import dataclasses

from ..models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22528, vocab=256000, head_dim=128, rope_theta=1e4,
    tie_embeddings=True,   # command-r ties input/output embeddings
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, attn_chunk=32, loss_chunk=32)
