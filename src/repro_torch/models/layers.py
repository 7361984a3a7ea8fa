"""Shared building blocks: norms, MLPs, embeddings, rotary embeddings
(port of ``repro/models/layers.py``).

Conventions
-----------
* Every module is an (init, apply) pair over plain dicts of tensors, with
  the JAX package's names and ``[in, out]`` einsum layouts, so a JAX
  parameter tree converts leaf by leaf (``repro_torch.convert``).
* Params are created in float32; ``apply`` casts to the compute dtype
  carried by the activations (a no-op for leaves already cast once by
  ``convert.to_compute_dtype``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               in_dim: int) -> Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in)), cut at +-2 std as
    ``jax.random.truncated_normal(-2, 2) * std`` is. ``trunc_normal_``'s
    bounds are absolute values, hence a = -2 std, b = 2 std."""
    std = 1.0 / math.sqrt(in_dim)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=gen)


def embed_init(gen: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


# ---------------------------------------------------------------------------
# RMSNorm (gemma-style (1 + scale))
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, device: torch.device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm in fp32 with (1 + scale); scale==0 init is identity."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP: gated (SwiGLU / GeGLU) and non-gated variants
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # JAX's approximate=True
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True) -> dict:
    p = {"wi": dense_init(gen, (d_model, d_ff), d_model),
         "wo": dense_init(gen, (d_ff, d_model), d_ff)}
    if gated:
        p["wg"] = dense_init(gen, (d_model, d_ff), d_model)
    return p


def mlp(params: dict, x: Tensor, act: str = "silu") -> Tensor:
    """[B, S, D] -> [B, S, D]. Gated if params carry ``wg``."""
    dtype = x.dtype
    fn = _ACTS[act]
    h = torch.einsum("bsd,df->bsf", x, params["wi"].to(dtype))
    if "wg" in params:
        g = torch.einsum("bsd,df->bsf", x, params["wg"].to(dtype))
        h = fn(g) * h
    else:
        h = fn(h)
    return torch.einsum("bsf,fd->bsd", h, params["wo"].to(dtype))


# ---------------------------------------------------------------------------
# Token embedding (tied or untied unembedding)
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   tied: bool) -> dict:
    p = {"table": embed_init(gen, (vocab, d_model))}
    if not tied:
        p["unembed"] = dense_init(gen, (d_model, vocab), d_model)
    return p


def embed_tokens(params: dict, tokens: Tensor, scale: bool,
                 dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """[B, S] int -> [B, S, D]. The table is cast before the gather and the
    sqrt(d) scale is applied in the compute dtype."""
    table = params["table"].to(dtype)
    x = table[tokens.long()]
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=dtype,
                             device=x.device)
    return x


def unembed(params: dict, x: Tensor, softcap: Optional[float]) -> Tensor:
    """[B, S, D] -> [B, S, V] logits (fp32): matmul in the compute dtype,
    then the cast, then the softcap."""
    w = params.get("unembed")
    if w is None:
        logits = torch.einsum("bsd,vd->bsv", x, params["table"].to(x.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    logits = logits.float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Apply RoPE, NeoX style (each head split into halves).
    x: [B, S, N, H], positions: [B, S]."""
    h = x.shape[-1]
    half = h // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq              # [B, S, half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
