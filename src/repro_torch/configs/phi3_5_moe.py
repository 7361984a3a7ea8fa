"""Phi-3.5-MoE 42B-A6.6B (hf:microsoft/Phi-3.5-MoE-instruct).

32L d_model=4096 32H (GQA kv=8) d_ff=6400, MoE 16 experts top-2, vocab 32064.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    num_experts_per_tok=2,
    mlp_act="silu",
    tie_embeddings=False,
)
