"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d4096 32H (GQA kv=2) ff13696 v151552."""
import dataclasses

from ..models.transformer import TransformerConfig

FAMILY = "lm"

CONFIG = TransformerConfig(
    name="glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, head_dim=128, rope_theta=1e4,
    tie_embeddings=False,
)

# Pure full attention: a 524288-token KV with O(S) per-token decode reads on
# EVERY layer has no sub-quadratic path — skipped per the assignment note
# (see DESIGN.md §Arch-applicability).
SKIP_SHAPES = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, head_dim=16, attn_chunk=32, loss_chunk=32)
