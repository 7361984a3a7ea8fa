"""Multi-head attention: MHA / GQA / MQA with RoPE (or none, under absolute
positions), logit softcap, sliding-window (local) masking, optional QKV
bias, input and output widths other than d_model (zamba2's shared block),
and the KV cache (port of ``repro/models/attention.py``: ``attend_full``, ``attend_prefill``,
``attend_decode``, the cache functions and ``_project_qkv``).

``impl="kernel"`` goes through ``kernels.ops`` (``flash_attention`` for a
whole sequence, ``decode_attention`` for one token: the CUDA kernels on
CUDA tensors, their plain versions on the CPU); ``impl="torch"`` is the JAX
package's XLA path written in PyTorch. The kernels do the
probability-times-V product in fp32, the torch path casts the
probabilities to the compute dtype first (as the XLA path does), so the two
agree to fp32 rounding in float32 and to bf16 rounding (2e-2) in bfloat16.

The cache is updated in place: ``update_cache``, ``fill_cache``,
``attend_prefill`` and ``attend_decode`` write into the tensors of the dict
they are given and return that same dict, where the reference returns a new
cache. A copy per decoded token would move the whole cache (545 MB for
gemma2-2b at 5120 positions in bf16), more than the step itself reads.

``constrain`` is a callback (x, logical_axes) -> x for sharding
annotations, called at the reference's points; the default is the
identity, and the mesh-aware one is ``distributed.sharding.constrain``.
``attn_axes`` and ``cache_axes`` name each leaf's logical axes;
``cache_spec`` is the cache as meta tensors.

On a mesh (DTensors) the sites DTensor cannot be left to run on each
rank's shard, with the layout pinned (``placement.per_shard``; on plain
tensors each is the same einsum):
* the q/k/v projection (``_heads_proj``, through ``layers.dense``): where
  the heads do not divide the model axis, DTensor's einsum split the
  flattened N*H over it and its unflatten then failed;
* the scores and the probability-times-V product (``_scores``, ``_mix``)
  and the output projection (``_out_proj``): torch 2.11's DTensor refuses
  the einsums' flatten of batch and heads split over different mesh axes,
  and of a split inner dimension; a key or head shard gives a partial sum;
* the in-place cache write (``update_cache``, ``placement.write_at``):
  DTensor refuses an in-place ``index_put_`` into a cache sharded along the
  sequence (``rules_for``'s kv_seq), so each rank writes, in place, the
  rows whose position falls in its own slice of the cache.
``attend_prefill`` pins q's rows, the logits and its output as
``attend_full`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import Partial

from .. import resolve_device
from ..kernels import ops as kops
from ..placement import on_mesh_of, per_shard, write_at
from . import layers
from .layers import Constrain, Tensor, dense_init, no_constraint

NEG_INF = -2.3819763e38  # bf16-safe large negative


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10000.0   # None = no RoPE (absolute pos)
    logit_softcap: Optional[float] = None
    window: Optional[int] = None            # sliding window (local layers)
    scale: Optional[float] = None           # default head_dim ** -0.5
    q_in_dim: Optional[int] = None          # != d_model for zamba2's concat in
    out_dim: Optional[int] = None           # output projection width

    @property
    def resolved_scale(self) -> float:
        return self.scale if self.scale is not None else self.head_dim ** -0.5

    @property
    def in_dim(self) -> int:
        return self.q_in_dim or self.d_model

    @property
    def o_dim(self) -> int:
        return self.out_dim or self.d_model


def attn_init(gen: Optional[torch.Generator], cfg: AttnConfig) -> dict:
    d, h = cfg.in_dim, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.num_heads, h), d),
        "wk": dense_init(gen, (d, cfg.num_kv_heads, h), d),
        "wv": dense_init(gen, (d, cfg.num_kv_heads, h), d),
        "wo": dense_init(gen, (cfg.num_heads, h, cfg.o_dim),
                         cfg.num_heads * h),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((heads, h), dtype=torch.float32,
                                  device=layers.gen_device(gen))
    return p


def attn_axes(cfg: AttnConfig) -> dict:
    p = {
        "wq": ("fsdp", "heads", "head_dim"),
        "wk": ("fsdp", "kv_heads", "head_dim"),
        "wv": ("fsdp", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "fsdp"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads", "head_dim")
        p["bk"] = ("kv_heads", "head_dim")
        p["bv"] = ("kv_heads", "head_dim")
    return p


def _heads_proj(x: Tensor, w: Tensor) -> Tensor:
    """[B, S, D] x [D, N, H] -> [B, S, N, H] (``layers.dense``: the heads
    split only where w's are; DTensor's einsum may split the flattened
    N*H over the model axis where N does not divide it, and its unflatten
    then fails)."""
    return layers.dense("bsd,dnh->bsnh", x, w, {"head": 1}, {"head": 2})


def _project_qkv(params: dict, cfg: AttnConfig, x: Tensor,
                 positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    dtype = x.dtype
    q = _heads_proj(x, params["wq"].to(dtype))
    k = _heads_proj(x, params["wk"].to(dtype))
    v = _heads_proj(x, params["wv"].to(dtype))
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
                 ref: Tensor) -> Tensor:
    """[s_q, s_k] boolean mask on the device (and mesh) of ``ref``; True =
    attend."""
    qi = torch.arange(s_q, device=ref.device)[:, None]
    ki = torch.arange(s_k, device=ref.device)[None, :]
    m = ki <= qi
    if window is not None:
        m = m & (ki > qi - window)
    return on_mesh_of(ref, m)


def _attend(cfg: AttnConfig, q: Tensor, k: Tensor, v: Tensor, impl: str,
            constrain: Constrain = no_constraint) -> Tensor:
    """Causal attention of q [B,S,N,H] over k, v [B,S,K,H] from position 0.
    ``constrain`` pins the torch path's [S, S] logits and probabilities."""
    if impl == "kernel":
        return kops.flash_attention(q, k, v, scale=cfg.resolved_scale,
                                    window=cfg.window,
                                    softcap=cfg.logit_softcap)
    if impl != "torch":
        raise ValueError(f"attention impl {impl!r}: 'kernel' or 'torch'")
    k = _repeat_kv(k, cfg.num_heads)
    v = _repeat_kv(v, cfg.num_heads)
    # batch x heads, and q rows context-parallel where the heads do not
    # divide the model axis, so the [S, S] logits are never replicated
    q = constrain(q, ("batch", "act_seq_q", "act_heads", None))
    logits = _scores(q, k) * cfg.resolved_scale
    lg_axes = ("batch", "act_heads", "act_seq_q", None)
    logits = constrain(logits, lg_axes)
    logits = layers.softcap(logits.float(), cfg.logit_softcap)
    mask = _causal_mask(q.shape[1], k.shape[1], cfg.window, logits)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = constrain(probs, lg_axes)
    return _mix(probs, v)


def _scores(q: Tensor, k: Tensor) -> Tensor:
    """q [B, Q, N, H] . k [B, K, N, H] -> [B, N, Q, K]. On a mesh on each
    rank's shard (``placement.per_shard``), batch, heads, q rows and keys
    kept split: torch 2.11's DTensor refuses the einsum's flatten of batch
    and heads split over different mesh axes."""
    return per_shard(lambda q, k: torch.einsum("bqnh,bknh->bnqk", q, k),
                     (q, {"batch": 0, "q": 1, "head": 2}),
                     (k, {"batch": 0, "k": 1, "head": 2}),
                     out={"batch": 0, "head": 1, "q": 2, "k": 3})


def _mix(probs: Tensor, v: Tensor) -> Tensor:
    """probs [B, N, Q, K] . v [B, K, N, H] -> [B, Q, N, H], on each rank's
    shard as ``_scores``; a key shard gives a partial sum over the keys."""
    return per_shard(lambda p, v: torch.einsum("bnqk,bknh->bqnh", p, v),
                     (probs, {"batch": 0, "head": 1, "q": 2, "k": 3}),
                     (v, {"batch": 0, "k": 1, "head": 2}),
                     out={"batch": 0, "q": 1, "head": 2, "k": Partial()})


def _out_proj(params: dict, o: Tensor, dtype: torch.dtype) -> Tensor:
    """[B, Q, N, H] -> [B, Q, O] (``layers.dense``, a head shard giving a
    partial sum: torch 2.11's DTensor orders the contracted dimensions
    heads last and refuses to flatten a split inner dimension)."""
    return layers.dense("bqnh,nho->bqo", o, params["wo"].to(dtype),
                        {"head": 0}, {"head": Partial()}, x_dims={"head": 2})


def attend_full(params: dict, cfg: AttnConfig, x: Tensor, positions: Tensor,
                impl: str = "kernel",
                constrain: Constrain = no_constraint) -> Tensor:
    """Causal self-attention over the whole sequence. x: [B, S, D]."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    q = constrain(q, ("batch", "act_seq", "act_heads", None))
    k = constrain(k, ("batch", "act_seq", "act_kv_heads", None))
    v = constrain(v, ("batch", "act_seq", "act_kv_heads", None))
    o = _attend(cfg, q, k, v, impl, constrain)
    o = constrain(o, ("batch", "act_seq", "act_heads", None))
    return _out_proj(params, o, x.dtype)


# ---------------------------------------------------------------------------
# KV cache + decode attention
# ---------------------------------------------------------------------------


def init_cache(batch: int, max_seq: int, cfg: AttnConfig,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_spec(batch: int, max_seq: int, cfg: AttnConfig,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The cache as meta tensors (shapes and dtypes, no data)."""
    return init_cache(batch, max_seq, cfg, dtype, layers.META)


def cache_axes() -> dict:
    return {"k": ("batch", "kv_seq", "act_kv_heads", None),
            "v": ("batch", "kv_seq", "act_kv_heads", None)}


def update_cache(cache: dict, k_new: Tensor, v_new: Tensor,
                 pos: Tensor) -> dict:
    """Write one new token per sequence, in place. k_new: [B, 1, K, H],
    pos: [B]. Returns ``cache``."""
    idx = on_mesh_of(k_new, torch.arange(k_new.shape[0], device=k_new.device))
    p = pos.long()
    write_at(cache["k"], idx, p, k_new[:, 0])
    write_at(cache["v"], idx, p, v_new[:, 0])
    return cache


def fill_cache(cache: dict, k_new: Tensor, v_new: Tensor) -> dict:
    """Prefill: write the first S positions wholesale, in place.
    k_new: [B, S, K, H]. Returns ``cache``."""
    s = k_new.shape[1]
    cache["k"][:, :s] = k_new.to(cache["k"].dtype)
    cache["v"][:, :s] = v_new.to(cache["v"].dtype)
    return cache


def attend_prefill(params: dict, cfg: AttnConfig, x: Tensor,
                   positions: Tensor, cache: dict,
                   impl: str = "kernel",
                   constrain: Constrain = no_constraint) -> tuple[Tensor, dict]:
    """Prefill: full attention over the prompt, which starts at position
    0, AND fill the cache (in the cache's dtype; the attention itself runs
    on the unrounded k and v, as the reference's does)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    cache = fill_cache(cache, k, v)
    q = constrain(q, ("batch", "act_seq", "act_heads", None))
    o = _attend(cfg, q, k, v, impl, constrain)
    o = constrain(o, ("batch", "act_seq", "act_heads", None))
    return _out_proj(params, o, x.dtype), cache


def attend_decode(params: dict, cfg: AttnConfig, x: Tensor, cache: dict,
                  pos: Tensor, impl: str = "kernel",
                  constrain: Constrain = no_constraint) -> tuple[Tensor, dict]:
    """One-token decode. x: [B, 1, D], pos: [B] (current write index).

    Writes the token's k and v at ``pos`` into ``cache`` (in place) and
    attends over keys ``[max(0, pos - window + 1), pos]``. Returns
    (out [B, 1, D], cache). The softmax statistics are fp32.
    """
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])
    cache = update_cache(cache, k_new, v_new, pos)
    if impl == "kernel":
        o = kops.decode_attention(q[:, 0], cache["k"], cache["v"], pos,
                                  scale=cfg.resolved_scale, window=cfg.window,
                                  softcap=cfg.logit_softcap)[:, None]
    elif impl == "torch":
        # a cache in another dtype than q is promoted, as XLA promotes it
        dtype = torch.promote_types(q.dtype, cache["k"].dtype)
        axes = ("batch", "kv_seq", "act_kv_heads", "head_dim")
        k, v = constrain(cache["k"], axes), constrain(cache["v"], axes)
        kh = _repeat_kv(k, cfg.num_heads).to(dtype)
        vh = _repeat_kv(v, cfg.num_heads).to(dtype)
        logits = _scores(q.to(dtype), kh) * cfg.resolved_scale
        # the logits follow the cache: its sequence axis where the cache is
        # sequence-sharded, its head axis otherwise
        lg_axes = ("batch", "act_kv_heads", None, "kv_seq")
        logits = constrain(logits, lg_axes)
        logits = layers.softcap(logits.float(), cfg.logit_softcap)
        ki = on_mesh_of(logits, torch.arange(
            kh.shape[1], device=q.device)[None, None, None, :])
        p = pos.long()[:, None, None, None]
        mask = ki <= p
        if cfg.window is not None:
            mask = mask & (ki > p - cfg.window)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype).to(dtype)
        probs = constrain(probs, lg_axes)
        o = _mix(probs, vh)
    else:
        raise ValueError(f"attention impl {impl!r}: 'kernel' or 'torch'")
    return _out_proj(params, o, x.dtype), cache
