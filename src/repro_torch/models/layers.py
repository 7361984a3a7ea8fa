"""Shared building blocks: norms, MLPs, embeddings, rotary and sinusoidal
position embeddings (port of ``repro/models/layers.py``).

Conventions
-----------
* Every module is an (init, apply) pair over plain dicts of tensors, with
  the JAX package's names and ``[in, out]`` einsum layouts, so a JAX
  parameter tree converts leaf by leaf (``repro_torch.convert``).
* Params are created in float32; ``apply`` casts to the compute dtype
  carried by the activations (a no-op for leaves already cast once by
  ``convert.to_compute_dtype``).
* ``*_axes`` functions return a tree of logical-axis tuples with the same
  structure as the params; ``distributed.sharding`` maps them onto a
  ``DeviceMesh``.
* An init helper given ``gen=None`` makes meta tensors (shapes and dtypes,
  no data): ``model.param_spec`` builds the parameter tree that way.
* On a mesh the activations are ``DTensor``s, and a DTensor op takes no
  plain tensor beside one: a tensor the model makes itself (a scale,
  positions, a mask) joins the mesh through ``on_mesh_of``. Every weight
  applied to activations goes through ``dense`` (per-rank shards, the
  layout pinned), and the embedding gather through ``per_shard``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial

from ..placement import on_mesh_of, per_shard

Tensor = torch.Tensor
META = torch.device("meta")
#: a sharding callback (x, logical axes) -> x; the default is ``no_constraint``
Constrain = Callable[[Tensor, tuple], Tensor]


def no_constraint(x: Tensor, _: tuple) -> Tensor:
    return x


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """The device an init draws on: the generator's, meta without one."""
    return META if gen is None else gen.device

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: Optional[torch.Generator], shape: tuple[int, ...],
               in_dim: int) -> Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in)), cut at +-2 std as
    ``jax.random.truncated_normal(-2, 2) * std`` is. ``trunc_normal_``'s
    bounds are absolute values, hence a = -2 std, b = 2 std."""
    t = torch.empty(shape, dtype=torch.float32, device=gen_device(gen))
    if gen is None:
        return t
    std = 1.0 / math.sqrt(in_dim)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=gen)


def embed_init(gen: Optional[torch.Generator],
               shape: tuple[int, ...]) -> Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen_device(gen))


# ---------------------------------------------------------------------------
# a weight applied to activations
# ---------------------------------------------------------------------------

#: the batch and sequence dimensions of an activation [B, S, ...]
TOKENS = {"batch": 0, "seq": 1}


def dense(eq: str, x: Tensor, w: Tensor, w_dims: dict, out_dims: dict,
          x_dims: Optional[dict] = None) -> Tensor:
    """``torch.einsum(eq, x, w)`` of activations ``x`` [B, S, ...] and a
    weight ``w``. On a mesh on each rank's shard (``placement.per_shard``):
    the batch and sequence shards of ``x`` (and those it names in
    ``x_dims``) stay, so do ``w``'s along ``w_dims``, the output split along
    ``out_dims`` there (or a partial sum, ``Partial()``, where the
    dimension is contracted), and every other shard of ``w`` (FSDP's) is
    gathered first. Left to itself, DTensor's einsum may gather the
    activations' batch instead of the weight, and run the whole product on
    every rank; and torch 2.11's refuses to flatten a split inner
    dimension."""
    return per_shard(lambda x, w: torch.einsum(eq, x, w),
                     (x, {**TOKENS, **(x_dims or {})}), (w, w_dims),
                     out={**TOKENS, **out_dims})


# ---------------------------------------------------------------------------
# RMSNorm (gemma-style (1 + scale))
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, device: torch.device) -> dict:
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm_axes() -> dict:
    return {"scale": (None,)}


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


def mlp_axes(gated: bool = True) -> dict:
    p = {"wi": ("fsdp", "ffn"), "wo": ("ffn", "fsdp")}
    if gated:
        p["wg"] = ("fsdp", "ffn")
    return p


def mlp(params: dict, x: Tensor, act: str = "silu") -> Tensor:
    """[B, S, D] -> [B, S, D]. Gated if params carry ``wg``."""
    dtype = x.dtype
    fn = _ACTS[act]
    h = dense("bsd,df->bsf", x, params["wi"].to(dtype), {"ffn": 1},
              {"ffn": 2})
    if "wg" in params:
        g = dense("bsd,df->bsf", x, params["wg"].to(dtype), {"ffn": 1},
                  {"ffn": 2})
        h = fn(g) * h
    else:
        h = fn(h)
    return dense("bsf,fd->bsd", h, params["wo"].to(dtype), {"ffn": 0},
                 {"ffn": Partial()}, x_dims={"ffn": 2})


# ---------------------------------------------------------------------------
# Token embedding (tied or untied unembedding)
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d_model: int,
                   tied: bool) -> dict:
    p = {"table": embed_init(gen, (vocab, d_model))}
    if not tied:
        p["unembed"] = dense_init(gen, (d_model, vocab), d_model)
    return p


def embedding_axes(tied: bool) -> dict:
    p = {"table": ("vocab", "fsdp")}
    if not tied:
        p["unembed"] = ("fsdp", "vocab")
    return p


def embed_tokens(params: dict, tokens: Tensor, scale: bool,
                 dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """[B, S] int -> [B, S, D]. The table is cast before the gather and the
    sqrt(d) scale is applied in the compute dtype. On a mesh the gather runs
    on each rank's token shard over the whole table
    (``placement.per_shard``): torch 2.11's DTensor has no strategy for an
    index over tokens sharded on two mesh axes (batch over pod and data),
    and its backward's ``index_put`` makes an unnormalised placement."""
    table = params["table"].to(dtype)
    x = per_shard(lambda t, i: t[i.long()], (table, {}),
                  (tokens, {"batch": 0, "seq": 1}),
                  out={"batch": 0, "seq": 1})
    if scale:
        # made on the device (not copied there from the host), so that a
        # CUDA graph can capture it
        x = x * on_mesh_of(x, torch.full((), math.sqrt(table.shape[-1]),
                                         dtype=dtype, device=x.device))
    return x


def unembed(params: dict, x: Tensor, softcap: Optional[float]) -> Tensor:
    """[B, S, D] -> [B, S, V] logits (fp32): matmul in the compute dtype,
    then the cast, then the softcap."""
    w = params.get("unembed")
    if w is None:
        logits = dense("bsd,vd->bsv", x, params["table"].to(x.dtype),
                       {"vocab": 0}, {"vocab": 2})
    else:
        logits = dense("bsd,dv->bsv", x, w.to(x.dtype), {"vocab": 1},
                       {"vocab": 2})
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
    freq = on_mesh_of(x, theta ** (-torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freq              # [B, S, half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_pos(positions: Tensor, d_model: int,
                   dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Sinusoidal absolute position embedding [B, S] -> [B, S, D]
    (MusicGen's): [sin | cos] of the float32 angles, cast last."""
    half = d_model // 2
    freq = on_mesh_of(positions, torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
