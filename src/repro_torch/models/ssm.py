"""Mamba2 (SSD) block: in_proj -> causal conv -> selective scan -> gated out
(port of ``repro/models/ssm.py``: ``ssm_apply`` and its helpers).

  u [B,S,D] --in_proj--> [z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]
  (x|B|C) -> causal depthwise conv1d (K=4) -> silu
  dt -> softplus(dt + dt_bias);  A = -exp(A_log)  (scalar per head)
  y = SSD(x, dt, A, B, C, D)
  out = out_proj( RMSNorm(y * silu(z)) )

x stays in the compute dtype while B, C and dt are fp32, so the SSD kernel
takes mixed dtypes, as the Pallas one does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import Tensor, dense_init, rmsnorm, rmsnorm_init


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


def ssm_init(gen: torch.Generator, cfg: SSMConfig) -> dict:
    dev = gen.device
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


def _split_proj(cfg: SSMConfig, zxbcdt: Tensor):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + cfg.conv_channels]
    dt = zxbcdt[..., di + cfg.conv_channels:]
    assert dt.shape[-1] == cfg.heads
    return z, xbc, dt


def _causal_conv(params: dict, xbc: Tensor) -> Tensor:
    """Depthwise causal conv1d over [B, S, C] with kernel K: k-1 zeros of
    left padding, weights [K, C] as the JAX package stores them."""
    k, c = params["conv_w"].shape
    w = params["conv_w"].to(xbc.dtype).t().reshape(c, 1, k)   # [C, 1, K]
    xt = F.pad(xbc.transpose(1, 2), (k - 1, 0))              # [B, C, S+k-1]
    out = F.conv1d(xt, w, groups=c).transpose(1, 2)
    return out + params["conv_b"].to(xbc.dtype)


def _run_ssd(cfg: SSMConfig, xh: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
             cmat: Tensor, d: Tensor, impl: str) -> tuple[Tensor, Tensor]:
    """The kernel or the torch chunked scan, with the sequence padded to a
    chunk multiple by ``ops.pad_to_chunk`` (padded tokens get dt=0: exact
    no-ops)."""
    if impl == "kernel":
        return kops.ssd(xh, dt, a, bmat, cmat, d, chunk=cfg.chunk)
    if impl != "torch":
        raise ValueError(f"ssm impl {impl!r}: 'kernel' or 'torch'")
    s = xh.shape[1]
    xh, dt, bmat, cmat, ch = kops.pad_to_chunk(cfg.chunk, xh, dt, bmat, cmat)
    y, fin = kref.ssd_chunked(xh, dt, a, bmat, cmat, d, chunk=ch)
    return y[:, :s], fin


def ssm_apply(params: dict, cfg: SSMConfig, u: Tensor,
              impl: str = "kernel") -> Tensor:
    """Full-sequence Mamba2 block. u: [B, S, D] -> [B, S, D]."""
    b, s, _ = u.shape
    dtype = u.dtype
    zxbcdt = torch.einsum("bsd,dk->bsk", u, params["in_proj"].to(dtype))
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(params, xbc))
    x = xbc[..., : cfg.d_inner]
    bmat = xbc[..., cfg.d_inner: cfg.d_inner + cfg.state].float()
    cmat = xbc[..., cfg.d_inner + cfg.state:].float()
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["A_log"])
    xh = x.reshape(b, s, cfg.heads, cfg.head_dim)
    y, _ = _run_ssd(cfg, xh, dt, a, bmat, cmat, params["D"], impl)
    y = y.reshape(b, s, cfg.d_inner)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return torch.einsum("bsk,kd->bsd", y, params["out_proj"].to(dtype))
