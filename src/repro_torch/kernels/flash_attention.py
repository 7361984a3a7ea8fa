"""Flash attention forward: binding of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``). The CUDA source says how it is laid out and what bounds
it. Its plain PyTorch version is ``ref.attention``; ``ops.flash_attention``
pads the sequence and picks between the two by the device of the tensors.

The source holds two kernels: bfloat16 runs the Hopper kernel (wgmma, a
TMA-fed K/V ring, a producer warp) at every head_dim of ``WGMMA_HEAD_DIMS``,
float32 the CUDA-core kernel. ``kernel_for`` names the one a call takes and
``kernel_launches`` counts each.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)
#: head dims at which bfloat16 runs the wgmma kernel (all of HEAD_DIMS)
WGMMA_HEAD_DIMS = HEAD_DIMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernels since the last reset (set to 0 to reset)
launches = 0
#: the same launches by kernel (see ``kernel_for``; reset by assigning zeros)
kernel_launches = {"wgmma": 0, "fp32": 0}


def _count(kernel: str) -> None:
    """One launch of ``kernel`` (``build.count``)."""
    build.count("flash_attention", kernel)


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel of ``csrc/flash_attention.cu`` a call in ``dtype`` at
    ``head_dim`` launches: "wgmma" (bfloat16) or "fp32"."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.float32 and head_dim in HEAD_DIMS:
        return "fp32"
    raise ValueError(f"no flash kernel for {dtype} at head_dim {head_dim}")


def wgmma_stages(head_dim: int) -> int:
    """Stages of the bfloat16 kernel's K/V ring at ``head_dim``: as many
    K and V tiles as fit beside Q in shared memory, at most 4 (2 at 160)."""
    if head_dim not in WGMMA_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {WGMMA_HEAD_DIMS}")
    return build.load().repro_flash_wgmma_stages(head_dim)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, from a 16-byte aligned base: the kernels read 16-byte
    chunks of rows."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(
    q: torch.Tensor,             # [B, Sq, N, H]
    k: torch.Tensor,             # [B, Sk, K, H]
    v: torch.Tensor,             # [B, Sk, K, H]
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns [B, Sq, N, H] in q's
    dtype. Raises on anything the kernel does not take."""
    build.check_inputs("flash_attention", q, k, v)
    b, sq, n, h = q.shape
    _, sk, kv, _ = k.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one of "
                         f"{sorted(map(str, _DTYPES))} for all three")
    if k.shape != (b, sk, kv, h) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if n % kv:
        raise ValueError(f"query heads {n} not a multiple of kv heads {kv}")
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = scale if scale is not None else h ** -0.5
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, sq, sk, n, kv, h, float(scale), int(causal),
            window or 0, float(softcap or 0.0), stream)
    build.check(lib, err, "flash_attention launch")
    _count(kernel_for(q.dtype, h))
    return out


def flops(b: int, sq: int, sk: int, n: int, h: int, causal: bool,
          window: Optional[int] = None) -> int:
    """Floating-point operations the inputs need (QK^T and PV over the
    unmasked (query, key) pairs only), 2 per multiply-add."""
    pairs = 0
    for qi in range(sq):
        hi = min(qi, sk - 1) if causal else sk - 1
        lo = max(0, qi - window + 1) if window is not None else 0
        pairs += max(hi - lo + 1, 0)
    return 4 * b * n * h * pairs
