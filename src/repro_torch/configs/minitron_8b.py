"""Minitron-8B (arXiv:2407.14679): pruned Nemotron-4.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="silu",
    tie_embeddings=False,
)
