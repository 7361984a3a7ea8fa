"""Mamba2 (SSD) block: in_proj -> causal conv -> selective scan -> gated out
(port of ``repro/models/ssm.py``: ``ssm_apply``, ``init_state``,
``ssm_decode`` and their helpers).

  u [B,S,D] --in_proj--> [z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]
  (x|B|C) -> causal depthwise conv1d (K=4) -> silu
  dt -> softplus(dt + dt_bias);  A = -exp(A_log)  (scalar per head)
  y = SSD(x, dt, A, B, C, D)
  out = out_proj( RMSNorm(y * silu(z)) )

x stays in the compute dtype while B, C and dt are fp32, so the SSD kernel
takes mixed dtypes, as the Pallas one does.

The front, everything between in_proj and the scan (the conv, its bias,
silu, the split of x, B and C, dt's softplus), is ``ops.mamba_front`` on
the kernel path with plain tensors: on CUDA one kernel
(``kernels/csrc/mamba_front.cu``) that reads in_proj's output in place and
writes the scan's inputs, on CPU and meta tensors ``kernels.ref.mamba_front``,
the same operations one by one. The torch path (training and the dry-run
pass ``ssm_impl="torch"``) and DTensors run the plain version's two halves
themselves: the conv as ``_causal_conv`` (on each rank's shard on a mesh),
the rest as ``kernels.ref.front_tail``. ``ssm_decode`` keeps its one-step
conv over the carried state.

The decode state is the last K-1 pre-conv inputs (fp32) and the SSM state
[B,H,N,P] (fp32). ``ssm_decode`` updates it in place and returns the dict
it was given, as the KV cache is (``attention.py``).

``ssm_axes`` and ``state_axes`` name each leaf's logical axes, and
``constrain`` (identity by default) pins the heads of the scan input, as in
the reference.

On a mesh, two ops run on each rank's shard (``placement.per_shard``),
with batch and channel or head shards kept and the sequence whole:
``_causal_conv``'s depthwise conv (``kernels.ref.causal_conv``), which
DTensor sends to its tensor-parallel handler (that takes only its own
layouts, in torch 2.11 not even replicated inputs with this padding, and
has no backward for a depthwise conv sharded over batch or channels), and
the torch path's SSD scan (``kernels.ref.ssd_chunked``, plain PyTorch:
DTensor in torch 2.11 has no sharding rule for the flip in its cumsum's
backward). The in and
out projections go through ``layers.dense`` (the batch and sequence shards
of the activations kept, the weight's FSDP shard gathered), and the scan's
output, flattened back to [B, S, d_inner], is ``placement.pinned``: in the
backward its gradient arrives split over the model axis, where the heads
do not divide it, and DTensor's unflatten to the heads then failed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial

from .. import resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..placement import per_shard, pinned
from . import layers
from .layers import (Constrain, Tensor, dense, dense_init, no_constraint,
                     rmsnorm, rmsnorm_axes, rmsnorm_init)


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    state: int                  # N
    heads: int                  # H
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        assert self.d_inner % self.heads == 0, (self.d_inner, self.heads)
        return self.d_inner // self.heads

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.state

    @property
    def proj_out(self) -> int:
        return 2 * self.d_inner + 2 * self.state + self.heads


def ssm_init(gen: Optional[torch.Generator], cfg: SSMConfig) -> dict:
    dev = layers.gen_device(gen)
    d, di = cfg.d_model, cfg.d_inner
    # A_log in [log 1, log 16] (mamba2 default); dt_bias so that
    # softplus(dt_bias) spans ~[1e-3, 1e-1]
    a = torch.log(torch.linspace(1.0, 16.0, cfg.heads, dtype=torch.float32,
                                 device=dev))
    u = torch.rand((cfg.heads,), generator=gen, dtype=torch.float32,
                   device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))   # inverse softplus
    return {
        "in_proj": dense_init(gen, (d, cfg.proj_out), d),
        "conv_w": 0.1 * torch.randn((cfg.conv_kernel, cfg.conv_channels),
                                    generator=gen, dtype=torch.float32,
                                    device=dev),
        "conv_b": torch.zeros((cfg.conv_channels,), dtype=torch.float32,
                              device=dev),
        "A_log": a,
        "D": torch.ones((cfg.heads,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm": rmsnorm_init(di, dev),
        "out_proj": dense_init(gen, (di, d), di),
    }


def ssm_axes() -> dict:
    return {
        "in_proj": ("fsdp", "ssm_inproj"),
        "conv_w": ("conv_kernel", None),
        "conv_b": (None,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": rmsnorm_axes(),
        "out_proj": ("ffn", "fsdp"),
    }


def _split_proj(cfg: SSMConfig, zxbcdt: Tensor):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + cfg.conv_channels]
    dt = zxbcdt[..., di + cfg.conv_channels:]
    assert dt.shape[-1] == cfg.heads
    return z, xbc, dt


def _causal_conv(params: dict, xbc: Tensor) -> Tensor:
    """``kref.causal_conv``, on each rank's batch and channel shard on a
    mesh."""
    return per_shard(kref.causal_conv, (xbc, {"batch": 0, "channel": 2}),
                     (params["conv_w"], {"channel": 1}),
                     out={"batch": 0, "channel": 2})


def _front(params: dict, cfg: SSMConfig, zxbcdt: Tensor, xbc_pre: Tensor,
           dt: Tensor, impl: str) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The scan's inputs from in_proj's output: (x [B,S,H,P] in the compute
    dtype, B, C [B,S,N] and dt [B,S,H] float32). ``ops.mamba_front`` (one
    kernel on CUDA, reading ``zxbcdt`` in place) for the kernel path on
    plain tensors; on the torch path and on DTensors, ``_causal_conv`` and
    ``kref.front_tail``."""
    if impl == "kernel" and not isinstance(zxbcdt, DTensor):
        return kops.mamba_front(zxbcdt, params["conv_w"], params["conv_b"],
                                params["dt_bias"], xbc_at=cfg.d_inner,
                                dt_at=cfg.d_inner + cfg.conv_channels,
                                state=cfg.state)
    return kref.front_tail(_causal_conv(params, xbc_pre), params["conv_b"],
                           dt, params["dt_bias"], state=cfg.state)


def _run_ssd(cfg: SSMConfig, xh: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
             cmat: Tensor, d: Tensor, impl: str) -> tuple[Tensor, Tensor]:
    """The kernel or the torch chunked scan, with the sequence padded to a
    chunk multiple by ``ops.pad_to_chunk`` (padded tokens get dt=0: exact
    no-ops). On a mesh the scan runs on each rank's batch and head shard."""
    if impl == "kernel":
        return kops.ssd(xh, dt, a, bmat, cmat, d, chunk=cfg.chunk)
    if impl != "torch":
        raise ValueError(f"ssm impl {impl!r}: 'kernel' or 'torch'")

    def scan(xh, dt, a, bmat, cmat, d):
        s = xh.shape[1]
        xh, dt, bmat, cmat, ch = kops.pad_to_chunk(cfg.chunk, xh, dt, bmat,
                                                   cmat)
        y, fin = kref.ssd_chunked(xh, dt, a, bmat, cmat, d, chunk=ch)
        return y[:, :s], fin
    bh = {"batch": 0, "head": 2}
    return per_shard(scan, (xh, bh), (dt, bh), (a, {"head": 0}),
                     (bmat, {"batch": 0}), (cmat, {"batch": 0}),
                     (d, {"head": 0}),
                     out=(bh, {"batch": 0, "head": 1}))


def ssm_full(params: dict, cfg: SSMConfig, u: Tensor,
             impl: str = "kernel",
             constrain: Constrain = no_constraint
             ) -> tuple[Tensor, Tensor, Tensor]:
    """Full-sequence Mamba2 block. u: [B, S, D] -> (out [B, S, D], the
    final SSM state [B,H,N,P] fp32, the pre-conv (x|B|C) [B, S, C])."""
    b, s, _ = u.shape
    dtype = u.dtype
    zxbcdt = dense("bsd,dk->bsk", u, params["in_proj"].to(dtype),
                   {"inner": 1}, {"inner": 2})
    z, xbc_pre, dt = _split_proj(cfg, zxbcdt)
    xh, bmat, cmat, dt = _front(params, cfg, zxbcdt, xbc_pre, dt, impl)
    a = -torch.exp(params["A_log"])
    xh = constrain(xh, ("batch", "act_seq", "act_heads", None))
    y, fin = _run_ssd(cfg, xh, dt, a, bmat, cmat, params["D"], impl)
    y = pinned(y.reshape(b, s, cfg.d_inner))
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = dense("bsk,kd->bsd", y, params["out_proj"].to(dtype),
                {"inner": 0}, {"inner": Partial()}, x_dims={"inner": 2})
    return out, fin, xbc_pre


def ssm_apply(params: dict, cfg: SSMConfig, u: Tensor,
              impl: str = "kernel",
              constrain: Constrain = no_constraint) -> Tensor:
    """Full-sequence Mamba2 block. u: [B, S, D] -> [B, S, D]."""
    return ssm_full(params, cfg, u, impl, constrain)[0]


# ---------------------------------------------------------------------------
# decode step with carried state
# ---------------------------------------------------------------------------


def init_state(batch: int, cfg: SSMConfig, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.conv_channels),
                            dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, cfg.heads, cfg.state, cfg.head_dim),
                           dtype=torch.float32, device=dev),
    }


def state_axes() -> dict:
    return {"conv": ("batch", None, None),
            "ssm": ("batch", "act_heads", None, None)}


def ssm_decode(params: dict, cfg: SSMConfig, u: Tensor,
               state: dict) -> tuple[Tensor, dict]:
    """One-token step. u: [B, 1, D] -> ([B, 1, D], state), the state
    advanced in place."""
    b = u.shape[0]
    dtype = u.dtype
    zxbcdt = dense("bsd,dk->bsk", u, params["in_proj"].to(dtype),
                   {"inner": 1}, {"inner": 2})
    z, xbc_new, dt = _split_proj(cfg, zxbcdt)              # [B,1,*]
    # conv over (state window + new input)
    window = torch.cat([state["conv"].to(dtype), xbc_new], dim=1)   # [B,K,C]
    w = params["conv_w"].to(dtype)                          # [K, C]
    conv_out = torch.einsum("bkc,kc->bc", window, w) + params["conv_b"].to(dtype)
    xbc = F.silu(conv_out)                                  # [B, C]
    x = xbc[:, : cfg.d_inner]
    bmat = xbc[:, cfg.d_inner: cfg.d_inner + cfg.state].float()
    cmat = xbc[:, cfg.d_inner + cfg.state:].float()
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"][None, :])  # [B, H]
    a = -torch.exp(params["A_log"])                         # [H]
    xh = x.reshape(b, cfg.heads, cfg.head_dim).float()
    decay = torch.exp(a[None, :] * dt)                      # [B, H]
    upd = torch.einsum("bn,bh,bhp->bhnp", bmat, dt, xh)
    ssm = decay[:, :, None, None] * state["ssm"] + upd
    y = torch.einsum("bn,bhnp->bhp", cmat, ssm)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, cfg.d_inner).to(dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = dense("bsk,kd->bsd", y, params["out_proj"].to(dtype),
                {"inner": 0}, {"inner": Partial()}, x_dims={"inner": 2})
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(ssm)
    return out, state
