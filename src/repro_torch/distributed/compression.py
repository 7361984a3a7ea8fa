"""Gradient compression with error feedback: int8 block quantization
(port of ``repro/distributed/compression.py``).

Int8 block quantization cuts the gradient bytes 4x (fp32 grads) while error
feedback (the residual carried to the next step) keeps the optimizer
trajectory unbiased: the 1-bit-Adam / EF-SGD recipe. The quantize ->
dequantize round trip happens before the optimizer update and reproduces
the exact value loss of the int8 representation. State (residuals) has the
gradients' shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..models.model import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclass(frozen=True)
class CompressionConfig:
    block: int = 256          # quantization group size (per-block scales)
    enabled: bool = True


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_dequant(g: Tensor, block: int) -> Tensor:
    """Simulated int8 block quantization (quant -> dequant round trip):
    scale max|block| / 127 (1 for an all-zero block), round half to even
    as ``jnp.round`` does."""
    flat = g.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.reshape(-1)[:n].reshape(g.shape)


def compress_with_feedback(grads: Any, err: Any, cfg: CompressionConfig
                           ) -> tuple[Any, Any]:
    """Returns (compressed grads, new error state)."""
    if not cfg.enabled:
        return grads, err

    def one(g, e):
        s = g.float() + e
        q = _quant_dequant(s, cfg.block)
        return q, s - q

    pairs = _zip_map(one, grads, err)
    return (tree_map(lambda pr: pr[0], pairs),
            tree_map(lambda pr: pr[1], pairs))


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def compressed_bytes(params: Any, cfg: CompressionConfig) -> tuple[int, int]:
    """(bytes on the wire with compression, without)."""
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    scales = sum((p.numel() + cfg.block - 1) // cfg.block * 4 for p in leaves)
    return n + scales, n * 4
