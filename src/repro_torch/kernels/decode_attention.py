"""Single-token decode attention: binding of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``). The CUDA source says how it is laid out and what
bounds it. Its plain PyTorch version is ``ref.decode_attention``;
``ops.decode_attention`` picks between the two by the device of the tensors.

The binding never copies the cache: a per-layer slice ``cache["k"][g]`` of a
contiguous stacked cache is itself contiguous and aligned, and anything else
is refused rather than cloned (a clone would read and write the whole cache
on every decoded token).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import build

#: the JAX package's key tile: the padding of the plain version in ``ops``
DEFAULT_BLOCK_K = 256
HEAD_DIMS = (16, 32, 64, 128, 256)
GROUPS = (1, 2, 4, 8, 16)
#: a group of 16 is built up to this head_dim (256 would need 64 KB of
#: static shared memory a block)
MAX_HEAD_DIM_G16 = 128
#: keys per tile: the live range of a sequence is cut into runs of whole
#: tiles, one run per block
TILE = 64
#: blocks the split grid aims at: four for each of the H100's 132 SMs, as
#: many as fit on an SM at once (128 threads of 128 registers each); at most
#: 1024 splits, which the merge kernel takes
TARGET_BLOCKS = 528
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q dtype, cache dtype) pairs the kernel takes; the output is in q's dtype
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def num_splits(b: int, kv: int, s: int, window: Optional[int]) -> int:
    """Blocks per (sequence, KV head): enough to fill the card, and no more
    than the tiles of the longest live range the cache can hold."""
    live = min(s, window) if window is not None else s
    want = -(-TARGET_BLOCKS // (b * kv))
    return max(1, min(want, -(-live // TILE)))


def decode_attention(
    q: torch.Tensor,             # [B, N, H]
    k_cache: torch.Tensor,       # [B, S, K, H]
    v_cache: torch.Tensor,       # [B, S, K, H]
    pos: torch.Tensor,           # [B] int, each in [0, S)
    *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; returns [B, N, H] in q's
    dtype. Raises on anything the kernel does not take."""
    global launches
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}: need [B,N,H] and [B,S,K,H]")
    b, n, h = q.shape
    _, s, kv, _ = k_cache.shape
    tensors = (q, k_cache, v_cache, pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention kernel needs q, the cache and pos "
                         "as CUDA tensors on one device")
    if (q.dtype, k_cache.dtype) not in _PAIRS or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v "
                         f"{v_cache.dtype}: the kernel takes (q, cache) in "
                         f"{sorted((str(a), str(c)) for a, c in _PAIRS)}")
    if k_cache.shape != (b, s, kv, h) or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} do not match")
    if tuple(pos.shape) != (b,) or pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"pos must be [B] int32 or int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if n % kv or n // kv not in GROUPS:
        raise ValueError(f"query heads {n} over kv heads {kv}: group size "
                         f"must be one of {GROUPS}")
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not in {HEAD_DIMS}")
    if n // kv == 16 and h > MAX_HEAD_DIM_G16:
        raise ValueError(f"a group of 16 query heads takes head_dim up to "
                         f"{MAX_HEAD_DIM_G16}, got {h}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             f"(the kernel does not copy the cache)")
    q = q.contiguous()
    pos = pos.to(torch.int32).contiguous()
    scale = scale if scale is not None else h ** -0.5
    splits = num_splits(b, kv, s, window)
    g = n // kv
    out = torch.empty_like(q)
    part_acc = torch.empty((b, kv, splits, g, h), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, kv, splits, g, 2), dtype=torch.float32,
                          device=q.device)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
            b, s, n, kv, h, splits, TILE, float(scale), window or 0,
            float(softcap or 0.0), stream)
    build.check(lib, err, "decode_attention launch")
    launches += 1
    return out


def live_keys(pos: Sequence[int], s: int, window: Optional[int]) -> list[int]:
    """Keys each sequence attends: ``[max(0, pos - window + 1), pos]``."""
    out = []
    for p in pos:
        lo = max(0, p - window + 1) if window is not None else 0
        out.append(max(min(p, s - 1) - lo + 1, 0))
    return out


def hbm_bytes(pos: Sequence[int], s: int, n: int, kv: int, h: int,
              window: Optional[int], q_bytes: int, kv_bytes: int) -> int:
    """Bytes the inputs need moved: the live K and V rows once, q and pos
    read and the output written once (the cache rows past pos, and before
    the window, are not counted: nothing needs them)."""
    live = sum(live_keys(pos, s, window))
    b = len(pos)
    return 2 * live * kv * h * kv_bytes + 2 * b * n * h * q_bytes + 4 * b


def flops(pos: Sequence[int], s: int, n: int, h: int,
          window: Optional[int]) -> int:
    """q.k and p.v over the live keys of every query head, 2 per
    multiply-add."""
    return 4 * n * h * sum(live_keys(pos, s, window))
