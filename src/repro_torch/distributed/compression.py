"""Gradient compression with error feedback: int8 block quantization
(port of ``repro/distributed/compression.py``).

Int8 block quantization cuts the gradient bytes 4x (fp32 grads) while error
feedback (the residual carried to the next step) keeps the optimizer
trajectory unbiased: the 1-bit-Adam / EF-SGD recipe. The quantize ->
dequantize round trip happens before the optimizer update and reproduces
the exact value loss of the int8 representation. State (residuals) has the
gradients' shapes.

On a mesh the blocks run across the flattened global array, as without
one. Where each rank's shard, flattened, is whole blocks of that array
(``_shards_hold_whole_blocks``), each rank quantises its own shard;
otherwise the gradient is made whole first (``placement.on_whole``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.model import tree_leaves, tree_map
from ..placement import on_whole

Tensor = torch.Tensor


@dataclass(frozen=True)
class CompressionConfig:
    block: int = 256          # quantization group size (per-block scales)
    enabled: bool = True


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


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


def _shards_hold_whole_blocks(x: DTensor, block: int) -> bool:
    """Whether each rank's shard of ``x``, flattened, is whole blocks of
    the flattened global array, in order: every placement is ``Shard`` or
    ``Replicate``, each sharded dimension splits evenly, and the shard's
    extent from its innermost sharded dimension on is a multiple of
    ``block`` (each contiguous run of the shard in the global order starts
    at a multiple of that extent)."""
    ways: dict[int, int] = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * x.device_mesh.size(i)
        elif not isinstance(p, Replicate):
            return False
    if any(x.shape[d] % k for d, k in ways.items()):
        return False
    if not ways:
        return True
    inner = max(ways)
    run = x.shape[inner] // ways[inner] * math.prod(x.shape[inner + 1:])
    return run % block == 0


def _quantise(x: Tensor, block: int) -> Tensor:
    """``_quant_dequant`` of ``x``; on a mesh on each rank's shard where
    its shards are whole blocks, else on the whole gradient."""
    if isinstance(x, DTensor) and _shards_hold_whole_blocks(x, block):
        return DTensor.from_local(_quant_dequant(x.to_local(), block),
                                  x.device_mesh, x.placements,
                                  run_check=False)
    return on_whole(lambda t: _quant_dequant(t, block), x)


def compress_with_feedback(grads: Any, err: Any, cfg: CompressionConfig
                           ) -> tuple[Any, Any]:
    """Returns (compressed grads, new error state). The new error is
    written into the leaves of ``err`` in place (``err`` itself is
    returned), so each leaf keeps its address across steps, as a captured
    CUDA graph of the train step needs; the reference returns new arrays of
    the same values."""
    if not cfg.enabled:
        return grads, err

    def one(g, e):
        s = g.float() + e
        q = _quantise(s, cfg.block)
        _write(e, s - q)
        return q

    return _zip_map(one, grads, err), err


def _write(e: Tensor, x: Tensor) -> None:
    """``e.copy_(x)``, ``x`` placed as ``e`` first on a mesh (a quantised
    gradient made whole comes back replicated)."""
    if isinstance(e, DTensor) and x.placements != e.placements:
        x = x.redistribute(e.device_mesh, e.placements)
    e.copy_(x)


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
