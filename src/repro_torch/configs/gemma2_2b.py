"""Gemma-2 2B (arXiv:2408.00118): local+global alternating, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, window 4096,
attn softcap 50, final softcap 30, GeGLU, head_dim 256.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("local", "global"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="gelu",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
)
