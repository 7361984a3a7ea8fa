"""Mamba2-130M (arXiv:2405.21060): SSD (state-space duality), attention-free.

24L d_model=768, ssm_state=128, expand 2 (d_inner=1536, 24 heads of 64),
vocab=50280.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=24,
    ssm_expand=2,
    layer_pattern=("mamba",),
    tie_embeddings=True,
)
