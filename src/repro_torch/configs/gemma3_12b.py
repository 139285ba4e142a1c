"""gemma3-12b [hf:google/gemma-3 family]: 48L d3840 16H (GQA kv=8) ff15360
v262144 — 5:1 local:global sliding window (1024), 128k+ context.

The 5:1 pattern is the sub-quadratic story: only every 6th layer carries a
full-length KV, local layers cap their cache at the 1024-token window —
this is the one LM arch that runs the long_500k cell.
"""
import dataclasses

from ..models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=256, rope_theta=1e6,
    sliding_window=1024, local_global_period=6, tie_embeddings=True,
    subquadratic=True,
)

SKIP_SHAPES = {}


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, sliding_window=16, local_global_period=3,
        attn_chunk=32, loss_chunk=32)
