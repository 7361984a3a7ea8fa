"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

Each wrapper picks the implementation by where the tensors live: on the
CPU it runs the plain PyTorch version from ``ref`` with the JAX package's
padding to tile boundaries, on CUDA it launches the hand-written kernel,
which raises on anything it does not take. The flash kernel masks ragged
sequence ends itself, so only the SSD scan is padded (to its chunk) on
CUDA. A CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import ref
from . import ssd as _ssd


def _pad_seq(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]   # F.pad counts from the last dim
    return F.pad(x, widths)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     f"tensors and their plain versions CPU tensors")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    block_q: int = _fa.DEFAULT_BLOCK_Q,
    block_k: int = _fa.DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """[B, Sq, N, H] x [B, Sk, K, H]^2 -> [B, Sq, N, H].

    ``block_q`` and ``block_k`` set the padding of the plain version, as
    the JAX package's tile sizes do; the CUDA kernel keeps its own tiles.
    """
    sq, sk = q.shape[1], k.shape[1]
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    assert causal or (sq % bq == 0 and sk % bk == 0), \
        "non-causal attention requires block-aligned sequence lengths"
    if _on_cuda(q, k, v):
        return _fa.flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap)
    # padded keys are masked for real queries by causality (ki >= sk > qi)
    out = ref.attention(_pad_seq(q, 1, bq), _pad_seq(k, 1, bk),
                        _pad_seq(v, 1, bk), scale=scale, causal=causal,
                        window=window, softcap=softcap)
    return out[:, :sq]


def pad_to_chunk(chunk: int, x: torch.Tensor, dt: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor):
    """(x, dt, B, C) padded along the sequence to a multiple of
    ``min(chunk, S)``, and that chunk. Padding tokens get dt=0: decay
    exp(A*0)=1 and zero input weight, so they are exact no-ops for both
    outputs and the carried state."""
    ch = min(chunk, x.shape[1])
    return tuple(_pad_seq(t, 1, ch) for t in (x, dt, B, C)) + (ch,)


def ssd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: torch.Tensor, *,
    chunk: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: ([B,S,H,P], ...) -> (y, final_state), the
    sequence padded with ``pad_to_chunk``."""
    s = x.shape[1]
    x, dt, B, C, ch = pad_to_chunk(chunk, x, dt, B, C)
    if _on_cuda(x, dt, A, B, C, D):
        y, fin = _ssd.ssd(x, dt, A, B, C, D, chunk=ch)
    else:
        y, fin = ref.ssd_chunked(x, dt, A, B, C, D, chunk=ch)
    return y[:, :s], fin
