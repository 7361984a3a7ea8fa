"""Architecture configuration system (copy of the JAX package's configs).

One module per architecture; each exposes ``CONFIG`` (the exact
published configuration) and the registry maps ``--arch <id>`` to it.
``smoke_config()`` returns a reduced same-family config for CPU tests.

``ArchConfig`` keeps every field of the JAX package's dataclass, so the two
compare equal under ``dataclasses.asdict``. ``ssm_impl`` and ``moe_impl``
name the JAX package's paths; the port chooses its own path with the
``*_impl`` arguments of ``models.model.forward``.

``ShapeCell``, ``SHAPES`` and ``cell_applicable`` are the JAX package's
input-shape cells (the dry-run's grid), copied.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    """A complete LM-family architecture description."""

    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // num_heads

    # attention variants
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: Optional[int] = None   # sliding-window size for local layers
    layer_pattern: tuple[str, ...] = ("global",)  # repeating per-layer kinds
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None   # default: head_dim ** -0.5

    # mlp variants
    mlp_act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    mlp_gated: bool = True            # False = vanilla 2-matrix MLP
    post_norms: bool = False          # gemma2-style post-sublayer RMSNorms
    pos_embed: str = "rope"           # "rope" | "absolute" (sinusoidal)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "einsum"

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0                # number of SSD heads
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    ssm_impl: str = "ref"

    # hybrid (zamba2-style shared attention block)
    shared_attn_every: int = 0

    # frontends (stubbed modalities)
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    frontend_dim: int = 1024

    # embedding
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma-style sqrt(d_model) scaling

    # runtime
    dtype: str = "bfloat16"
    remat: str = "none"
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (in decode-KV) archs: SSM, hybrid, and local+global
        dense models whose global layers are linear in KV at decode."""
        return self.family in ("ssm", "hybrid") or (
            self.local_window is not None and "local" in self.layer_pattern)


#: arch-id -> module name
_REGISTRY = {
    "musicgen-large": "musicgen_large",
    "gemma2-2b": "gemma2_2b",
    "qwen1.5-4b": "qwen1_5_4b",
    "minitron-8b": "minitron_8b",
    "gemma-2b": "gemma_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen3-moe-235b-a22b": "qwen3_moe",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi-3-vision-4.2b": "phi3_vision",
    "mamba2-130m": "mamba2_130m",
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ArchConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(arch)
    pat = len(cfg.layer_pattern)
    n_layers = max(pat, 2 if pat == 1 else pat)
    updates: dict = dict(
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 0,
        d_ff=128,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else None,
        frontend_tokens=min(cfg.frontend_tokens, 4),
        local_window=min(cfg.local_window, 8) if cfg.local_window else None,
        scan_layers=False,
    )
    if cfg.num_experts:
        updates.update(num_experts=4, num_experts_per_tok=2,
                       moe_capacity_factor=2.0)
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_heads=4, ssm_chunk=8)
    if cfg.shared_attn_every:
        updates.update(shared_attn_every=2, num_layers=4)
    return replace(cfg, **updates)


# --------------------------------------------------------------------------
# Input shape cells (the per-arch shape set of the dry-run)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k only runs on sub-quadratic archs."""
    if shape == "long_500k":
        return cfg.supports_long_context
    return True
