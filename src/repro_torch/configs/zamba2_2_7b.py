"""Zamba2-2.7B (arXiv:2411.15242): Mamba2 backbone + shared attention blocks.

54 Mamba2 blocks d_model=2560, ssm_state=64; a shared (weight-tied) attention
block (32H) is interleaved every 6 mamba blocks; d_ff=10240, vocab=32000.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=80,           # expand*d_model / head 64
    ssm_expand=2,
    layer_pattern=("mamba",),
    shared_attn_every=6,
    mlp_act="gelu",
    tie_embeddings=True,
)
