"""Phi-3-vision 4.2B (hf:microsoft/Phi-3-vision-128k-instruct).

phi3-mini backbone 32L d_model=3072 32H (GQA kv=32 -> MHA) d_ff=8192
vocab=32064 + CLIP frontend stubbed as precomputed patch embeddings.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_act="silu",
    frontend="vision_patches",
    frontend_tokens=576,
    tie_embeddings=True,
)
