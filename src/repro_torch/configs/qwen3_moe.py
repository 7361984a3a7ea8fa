"""Qwen3-MoE 235B-A22B-class (hf:Qwen/Qwen3-*): 128 experts top-8.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    num_experts=128,
    num_experts_per_tok=8,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    tie_embeddings=False,
)
