"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These are the semantic ground truth: the CPU path of every wrapper in
``ops`` and the comparison each CUDA kernel is held to on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def attention(
    q: torch.Tensor,           # [B, Sq, N, H]
    k: torch.Tensor,           # [B, Sk, K, H]
    v: torch.Tensor,           # [B, Sk, K, H]
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention with GQA, causal/local masking and softcap."""
    n = q.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kh = _repeat_kv(k, n)
    vh = _repeat_kv(v, n)
    logits = torch.einsum("bqnh,bknh->bnqk", q, kh).float() * scale
    logits = _softcap(logits, softcap)
    qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bknh->bqnh", probs, vh)


# ---------------------------------------------------------------------------
# Mamba2 SSD (sequential scan: the definition)
# ---------------------------------------------------------------------------


def ssd(
    x: torch.Tensor,           # [B, S, H, P]
    dt: torch.Tensor,          # [B, S, H]  (already softplus'd, > 0)
    A: torch.Tensor,           # [H]        (negative decay rates)
    B: torch.Tensor,           # [B, S, N]  (shared across heads, G=1)
    C: torch.Tensor,           # [B, S, N]
    D: torch.Tensor,           # [H]
    init_state: Optional[torch.Tensor] = None,   # [B, H, N, P]
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(A*dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t^T h_t + D x_t.
    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,N,P] fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    x32, dt32, B32, C32 = x.float(), dt.float(), B.float(), C.float()
    A32 = A.float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        a = torch.exp(A32[None, :] * dt32[:, t])                 # [B,H]
        upd = torch.einsum("bn,bh,bhp->bhnp", B32[:, t], dt32[:, t],
                           x32[:, t])
        state = a[:, :, None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", C32[:, t], state))
    y = torch.stack(ys, dim=1)
    y = y + D.float()[None, None, :, None] * x32
    return y.to(x.dtype), state


def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, chunk: int = 64,
    init_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked (state-space dual) formulation: the algorithm the kernel
    implements. Mathematically identical to ``ssd``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    x32 = x.float().reshape(b, nc, chunk, h, p)
    dt32 = dt.float().reshape(b, nc, chunk, h)
    B32 = B.float().reshape(b, nc, chunk, n)
    C32 = C.float().reshape(b, nc, chunk, n)
    A32 = A.float()

    la = A32[None, None, None, :] * dt32            # [b,nc,L,h] log-decay
    cum = torch.cumsum(la, dim=2)                   # inclusive
    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) dt_j x_j;
    # the j > i half is masked before exp so it never overflows
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # [b,nc,i,j,h]
    idx = torch.arange(chunk, device=x.device)
    mask = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    seg = torch.exp(torch.where(mask, diff, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", C32, B32)  # [b,nc,i,j]
    m = seg * cb[..., None] * dt32[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, x32)

    # inter-chunk: sequential state carry at chunk granularity
    chunk_decay = torch.exp(cum[:, :, -1, :])       # [b,nc,h]
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt32   # [b,nc,L,h]
    upd = torch.einsum("bcjn,bcjh,bcjhp->bchnp", B32, w, x32)

    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)                     # state *entering* chunk c
        state = chunk_decay[:, c, :, None, None] * state + upd[:, c]
    states_in = torch.stack(states_in, dim=1)       # [b,nc,h,n,p]
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", C32, torch.exp(cum),
                           states_in)
    y = y_intra + y_inter + D.float()[None, None, None, :, None] * x32
    return y.reshape(b, s, h, p).to(x.dtype), state
