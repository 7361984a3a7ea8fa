"""Mixture-of-Experts layer: top-k token-choice routing (port of
``repro/models/moe.py``).

Two dispatch implementations, chosen by ``moe_apply``'s ``impl``:

* ``"kernel"`` — the counterpart of the JAX package's ``moe_gmm``: the
  (token, choice) pairs are sorted by expert, the experts run as three
  grouped matmuls (``kernels.ops.gmm``: the CUDA kernel on CUDA tensors, its
  plain version on the CPU), and the outputs come back through the inverse
  permutation. No token is dropped. The card's path: nothing in it reads a
  device value back to the host.
* ``"einsum"`` — the counterpart of ``moe_einsum``, the JAX package's
  default ``moe_impl``: tokens are blocked into groups, each expert takes at
  most ``capacity`` (token, choice) pairs of a group in (token, choice)
  order, and the rest are dropped. The reference's one-hot dispatch and
  combine einsums are written here as a scatter into the expert slots and a
  gather back from them, which give the same result (each slot holds one
  pair, each pair one slot).

The two compute different functions wherever the capacity drops a pair.

On a mesh the router's ``topk`` runs on each rank's token shard
(``placement.per_shard``): its backward in torch 2.11 scatters the
gradient into a plain zero tensor, which DTensor refuses. So do the einsum
dispatch's per-group slot fill (each rank its own groups: a zero buffer the
model makes itself would be replicated, and every token gathered to fill
it), its combine (each rank its own groups' pairs whose expert lies in its
expert shard, from its local slots: a partial sum over the expert shards,
as GSPMD sums the reference's combine einsum), the expert counts (a
partial sum over the token shards) and the expert matmuls (``_experts``:
DTensor's einsum kept a shard of the contracted, FSDP-sharded dimension on
a dimension of size 1, which its view then refused to drop).

Router: softmax over the expert logits in fp32, top-k, renormalised weights,
and the Switch-style load-balance loss ``E * sum_e mean_prob_e *
mean_count_e``. ``moe_axes`` names each leaf's logical axes, and
``constrain`` (identity by default) pins the expert slots of the einsum
dispatch to the expert axis, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import Partial

from ..kernels import ops as kops
from ..placement import on_mesh_of, per_shard
from .layers import _ACTS, Constrain, Tensor, dense_init, no_constraint

IMPLS = ("kernel", "einsum")


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                   # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256       # dispatch group (einsum impl)
    act: str = "silu"


def moe_init(gen: Optional[torch.Generator], cfg: MoEConfig) -> dict:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, e), d),
        "wi": dense_init(gen, (e, d, f), d),
        "wg": dense_init(gen, (e, d, f), d),
        "wo": dense_init(gen, (e, f, d), f),
    }


def moe_axes() -> dict:
    return {
        "router": (None, None),
        "wi": ("experts", "fsdp", "ffn_noshard"),
        "wg": ("experts", "fsdp", "ffn_noshard"),
        "wo": ("experts", "ffn_noshard", "fsdp"),
    }


def _counts(flat_e: Tensor, e: int) -> Tensor:
    """Pairs per expert, int32, on the device of ``flat_e``. Not
    ``torch.bincount``: on CUDA it reads the largest index back to the
    host to size its output."""
    def count(flat_e):
        ones = torch.ones_like(flat_e, dtype=torch.int32)
        zeros = torch.zeros(e, dtype=torch.int32, device=flat_e.device)
        return zeros.scatter_add_(0, flat_e, ones)
    # on a mesh each rank counts its own pairs: a partial sum
    return per_shard(count, (flat_e, {"pair": 0}), out={"pair": Partial()})


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route(params: dict, cfg: MoEConfig, x: Tensor
          ) -> tuple[Tensor, Tensor, Tensor]:
    """Top-k routing. x: [T, D] ->
    (weights [T, k] in x's dtype, expert_idx [T, k] int32, aux_loss f32)."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # on a mesh on each token shard: topk's backward (torch 2.11) scatters
    # into a plain zero tensor, which DTensor refuses beside a DTensor grad
    weights, idx = per_shard(lambda p: torch.topk(p, cfg.top_k, dim=-1),
                             (probs, {"token": 0}),
                             out=({"token": 0}, {"token": 0}))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    e, t = cfg.num_experts, x.shape[0]
    me = probs.mean(dim=0)                                  # mean router prob
    ce = _counts(idx.reshape(-1), e).float() / t            # mean picks a token
    aux = e * torch.sum(me * ce)
    return weights.to(x.dtype), idx.to(torch.int32), aux


# ---------------------------------------------------------------------------
# einsum (capacity) dispatch
# ---------------------------------------------------------------------------


def _capacity(cfg: MoEConfig, group: int) -> int:
    c = int(math.ceil(group * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(c, cfg.top_k)


def capacity_slots(idx: Tensor, e: int, cap: int) -> tuple[Tensor, Tensor]:
    """idx: [G, n] experts of each group's (token, choice) pairs in order ->
    (rank of each pair among its expert's pairs of the group, kept mask:
    rank < cap). Pairs past an expert's capacity are dropped."""
    onehot = torch.nn.functional.one_hot(idx.long(), e)     # [G, n, e]
    before = torch.cumsum(onehot, dim=1) - onehot
    rank = before.gather(2, idx.long()[..., None])[..., 0]
    return rank, rank < cap


def _experts(x: Tensor, w: Tensor) -> Tensor:
    """Each expert's slots through its weights: [G, e, c, i] x [e, i, o]
    -> [G, e, c, o]. On a mesh on each rank's shard
    (``placement.per_shard``), the group and expert shards kept: DTensor's
    einsum keeps a shard of the contracted dimension (FSDP-sharded in w) on
    a dimension of size 1, which its view then refuses to drop."""
    return per_shard(lambda x, w: torch.einsum("Gecd,edf->Gecf", x, w),
                     (x, {"group": 0, "expert": 1}), (w, {"expert": 0}),
                     out={"group": 0, "expert": 1})


def moe_einsum(params: dict, cfg: MoEConfig, x: Tensor,
               constrain: Constrain = no_constraint) -> tuple[Tensor, Tensor]:
    """x: [B, S, D] -> ([B, S, D], aux_loss). Capacity-dropped dispatch."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.group_size, t)
    while t % g:                 # largest divisor of t <= group_size
        g -= 1
    n_groups = t // g
    xt = x.reshape(t, d)
    weights, idx, aux = route(params, cfg, xt)

    e, k, dtype = cfg.num_experts, cfg.top_k, x.dtype
    cap = _capacity(cfg, g)
    pairs = idx.reshape(n_groups, g * k)
    rank, keep = capacity_slots(pairs, e, cap)
    # slot of each kept pair in its group's [e * cap] expert slots; the
    # dropped ones go to one extra slot that is cut off again
    slot = torch.where(keep, pairs.long() * cap + rank, e * cap)
    src = xt.reshape(n_groups, g, 1, d).expand(n_groups, g, k, d)
    src = src.reshape(n_groups, g * k, d)

    def dispatch(src, slot):
        xe = torch.zeros((src.shape[0], e * cap + 1, d), dtype=dtype,
                         device=src.device)
        return xe.scatter_(1, slot[..., None].expand(-1, -1, d), src)
    # on a mesh each rank fills its own groups' slots
    xe = per_shard(dispatch, (src, {"group": 0}), (slot, {"group": 0}),
                   out={"group": 0})
    xe = xe[:, :e * cap].reshape(n_groups, e, cap, d)
    xe = constrain(xe, ("batch", "act_experts", None, None))

    h = _experts(xe, params["wi"].to(dtype))
    gt = _experts(xe, params["wg"].to(dtype))
    h = _ACTS[cfg.act](gt) * h
    ye = _experts(h, params["wo"].to(dtype))
    ye = constrain(ye, ("batch", "act_experts", None, None))
    # combine: each pair's slot back (the extra slot is zero), weighted and
    # summed over the k choices in fp32, as the combine einsum sums, then
    # cast to x's dtype, the einsum's output dtype

    def combine(ye, slot, w, ids):
        el = ye.shape[1]
        if el < e:
            # this rank's expert shard: a pair of another shard's expert
            # (or a dropped one) reads the zero slot
            local = slot - ids[:1] * cap
            slot = torch.where((local >= 0) & (local < el * cap), local,
                               el * cap)
        ye = torch.cat([ye.reshape(ye.shape[0], el * cap, d),
                        ye.new_zeros((ye.shape[0], 1, d))], dim=1)
        yk = ye.gather(1, slot[..., None].expand(-1, -1, d))
        yk = yk.reshape(-1, g, k, d).float()
        return (yk * w.reshape(-1, g, k, 1).float()).sum(dim=2).to(dtype)
    # on a mesh each rank sums its own groups' pairs over its own experts'
    # slots, handed its expert ids: a partial sum over the expert shards,
    # which the next constraint reduces (GSPMD's partial sums of the
    # combine einsum)
    ids = on_mesh_of(ye, torch.arange(e, device=slot.device))
    y = per_shard(combine, (ye, {"group": 0, "expert": 1}),
                  (slot, {"group": 0}),
                  (weights.reshape(n_groups, g * k), {"group": 0}),
                  (ids, {"expert": 0}),
                  out={"group": 0, "expert": Partial()})
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# sort-based dispatch + grouped matmul (the card's path)
# ---------------------------------------------------------------------------


def moe_gmm(params: dict, cfg: MoEConfig, x: Tensor
            ) -> tuple[Tensor, Tensor]:
    """x: [B, S, D] -> ([B, S, D], aux). Sort + grouped matmul. No value
    leaves the device: the group sizes stay there and the kernel reads
    them itself."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    weights, idx, aux = route(params, cfg, xt)

    k, dtype = cfg.top_k, x.dtype
    flat_e = idx.reshape(-1).long()                # [T*k]
    order = torch.argsort(flat_e, stable=True)     # as jnp.argsort
    xs = xt.index_select(0, order // k)            # [T*k, D] sorted by expert
    group_sizes = _counts(flat_e, cfg.num_experts)

    h = kops.gmm(xs, params["wi"].to(dtype), group_sizes)
    g = kops.gmm(xs, params["wg"].to(dtype), group_sizes)
    h = _ACTS[cfg.act](g) * h
    ys = kops.gmm(h, params["wo"].to(dtype), group_sizes)
    # combine: back through the inverse permutation to [T, k, D], weighted
    # and summed over k (deterministic, no atomics)
    inv = torch.empty_like(order).scatter_(
        0, order, on_mesh_of(order, torch.arange(order.numel(),
                                                 device=order.device)))
    yk = ys.index_select(0, inv).reshape(t, k, d)
    y = (yk * weights[..., None]).sum(dim=1)
    return y.reshape(b, s, d), aux


def moe_apply(params: dict, cfg: MoEConfig, x: Tensor,
              impl: str = "kernel",
              constrain: Constrain = no_constraint) -> tuple[Tensor, Tensor]:
    """``constrain`` applies to the einsum dispatch's expert slots; the
    kernel path takes none (its kernel takes no DTensor)."""
    if impl == "kernel":
        return moe_gmm(params, cfg, x)
    if impl == "einsum":
        return moe_einsum(params, cfg, x, constrain)
    raise ValueError(f"moe_impl {impl!r} not in {IMPLS}")


def flops_per_token(cfg: MoEConfig, impl: str = "kernel") -> int:
    """Analytic active MACs per token (experts + dispatch overhead)."""
    expert = cfg.top_k * 3 * cfg.d_model * cfg.d_ff
    router = cfg.d_model * cfg.num_experts
    if impl == "einsum":
        disp = 2 * cfg.group_size * cfg.top_k * cfg.capacity_factor * cfg.d_model
    else:
        disp = 0
    return int(expert + router + disp)
