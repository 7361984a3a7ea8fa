"""MusicGen-large (arXiv:2306.05284): decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 -> MHA) d_ff=8192 vocab=2048. The EnCodec
audio frontend is a stub: input_specs() provides precomputed frame embeddings.
"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_act="gelu",
    mlp_gated=False,
    pos_embed="absolute",
    frontend="audio_frames",
    frontend_tokens=256,
    tie_embeddings=False,
)
