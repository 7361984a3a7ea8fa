"""Gemma 2B (arXiv:2403.08295): GeGLU, head_dim=256, MQA (kv=1).

18L d_model=2048 8H d_ff=16384 vocab=256000.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
)
