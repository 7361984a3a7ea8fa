"""Multi-head attention: MHA / GQA / MQA with RoPE, logit softcap,
sliding-window (local) masking and optional QKV bias (port of
``repro/models/attention.py``: ``attend_full`` and ``_project_qkv``).

``impl="kernel"`` goes through ``kernels.ops.flash_attention`` (the CUDA
kernel on CUDA tensors, its plain version on the CPU); ``impl="torch"``
is the JAX package's XLA path written in PyTorch. The kernel does the
probability-times-V product in fp32, the torch path casts the
probabilities to the compute dtype first (as the XLA path does), so the two
agree to fp32 rounding in float32 and to bf16 rounding (2e-2) in bfloat16.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels import ops as kops
from . import layers
from .layers import Tensor, dense_init

NEG_INF = -2.3819763e38  # bf16-safe large negative


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0
    logit_softcap: Optional[float] = None
    window: Optional[int] = None            # sliding window (local layers)
    scale: Optional[float] = None           # default head_dim ** -0.5

    @property
    def resolved_scale(self) -> float:
        return self.scale if self.scale is not None else self.head_dim ** -0.5


def attn_init(gen: torch.Generator, cfg: AttnConfig) -> dict:
    d, h = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads, h), d),
        "wk": dense_init(gen, (d, cfg.num_kv_heads, h), d),
        "wv": dense_init(gen, (d, cfg.num_kv_heads, h), d),
        "wo": dense_init(gen, (cfg.num_heads, h, cfg.d_model),
                         cfg.num_heads * h),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((heads, h), dtype=torch.float32,
                                  device=gen.device)
    return p


def _project_qkv(params: dict, cfg: AttnConfig, x: Tensor,
                 positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    dtype = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dkh->bskh", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dkh->bskh", x, params["wv"].to(dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.rope_theta is not None:
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: Tensor, num_heads: int) -> Tensor:
    """[B, S, K, H] -> [B, S, N, H], each kv head repeated N/K times in place
    (``jnp.repeat``, not a tile)."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def _causal_mask(s_q: int, s_k: int, window: Optional[int],
                 device: torch.device) -> Tensor:
    """[s_q, s_k] boolean mask; True = attend."""
    qi = torch.arange(s_q, device=device)[:, None]
    ki = torch.arange(s_k, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m = m & (ki > qi - window)
    return m


def attend_full(params: dict, cfg: AttnConfig, x: Tensor, positions: Tensor,
                impl: str = "kernel") -> Tensor:
    """Causal self-attention over the whole sequence. x: [B, S, D]."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    if impl == "kernel":
        o = kops.flash_attention(q, k, v, scale=cfg.resolved_scale,
                                 window=cfg.window, softcap=cfg.logit_softcap)
    elif impl == "torch":
        k = _repeat_kv(k, cfg.num_heads)
        v = _repeat_kv(v, cfg.num_heads)
        logits = torch.einsum("bqnh,bknh->bnqk", q, k) * cfg.resolved_scale
        logits = layers.softcap(logits.float(), cfg.logit_softcap)
        mask = _causal_mask(q.shape[1], k.shape[1], cfg.window, x.device)
        logits = torch.where(mask[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.einsum("bnqk,bknh->bqnh", probs, v)
    else:
        raise ValueError(f"attention impl {impl!r}: 'kernel' or 'torch'")
    return torch.einsum("bqnh,nho->bqo", o, params["wo"].to(x.dtype))
