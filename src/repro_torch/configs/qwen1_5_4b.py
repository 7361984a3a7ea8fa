"""Qwen1.5-4B (hf:Qwen/Qwen1.5-*): QKV bias enabled.

40L d_model=2560 20H (GQA kv=20 -> MHA) d_ff=6912 vocab=151936.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    tie_embeddings=False,
)
