"""Single-token decode attention: binding of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``). The CUDA source holds two kernels and says how each
is laid out and what bounds it: "mma" (bf16 q over a bf16 cache, every call
of the served decode path: tensor cores over a ``cp.async`` ring, the splits
merged in the same launch) and "fp32" (float32 q over a float32 or bf16
cache, parity runs only: CUDA-core FMAs, then a second kernel that merges
the splits). ``kernel_for`` names the one a call takes and
``kernel_launches`` counts each. The plain PyTorch version is
``ref.decode_attention``; ``ops.decode_attention`` picks between the two by
the device of the tensors.

The binding never copies the cache: a per-layer slice ``cache["k"][g]`` of a
contiguous stacked cache is itself contiguous and aligned, and anything else
is refused rather than cloned (a clone would read and write the whole cache
on every decoded token). A bf16 call does no host work that depends on
``pos``: its merge counters live in a zeroed buffer that every call leaves
at zero. Eager calls take the buffer the binding keeps per (device, CUDA
stream), made (or grown) at a stream's first call, so that calls on two
streams at once never count into each other's counters. A call captured
into a CUDA graph takes a buffer of its own, made inside the capture from
the graph's private pool (one small zeroing node a replay) and never kept
for eager calls: a graph replays on whatever stream its caller names, so a
buffer keyed by the capture stream could be shared by two graphs replayed
at once.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import build

#: the JAX package's key tile: the padding of the plain version in ``ops``
DEFAULT_BLOCK_K = 256
HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)
GROUPS = (1, 2, 4, 8, 16)
#: the fp32 kernel takes a group of 16 up to this head_dim (256 would need
#: 64 KB of static shared memory a block); the mma kernel takes every head_dim
MAX_HEAD_DIM_G16_FP32 = 128
#: keys per tile: the live range of a sequence is cut into tiles, and each
#: block takes a run of whole tiles
TILE = 64
#: blocks the split grid aims at, by kernel. "mma": as many as the H100's
#: 132 SMs hold at once (``mma_blocks_per_sm``): one block alone streams far
#: below the card's rate, and a second wave would wait for the first.
#: "fp32": four for each SM, as many as fit at once (128 threads of 128
#: registers)
TARGET_BLOCKS = {"mma": 132, "fp32": 528}
#: the most splits each kernel merges: the mma kernel's merge keeps every
#: split's (m, l) and partial acc in shared memory (``MERGE_BYTES``), the fp32
#: merge kernel takes 1024
MAX_SPLITS = {"mma": 132, "fp32": 1024}
#: shared memory the mma kernel's merge may stage: a (m, l) row of 16 float2
#: and a [group, head_dim] fp32 acc per split
MERGE_BYTES = 200 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q dtype, cache dtype) -> the kernel that takes it; the output is in q's
#: dtype
_KERNELS = {(torch.bfloat16, torch.bfloat16): "mma",
            (torch.float32, torch.float32): "fp32",
            (torch.float32, torch.bfloat16): "fp32"}

#: launches of the CUDA kernels since the last reset (set to 0 to reset)
launches = 0
#: the same by kernel
kernel_launches = {"mma": 0, "fp32": 0}


def _count(kernel: str) -> None:
    """One launch of ``kernel`` (``build.count``)."""
    build.count("decode_attention", kernel)


#: per (device index, CUDA stream): the eager mma kernel's merge counters,
#: int32, zero between calls. A buffer is only ever used on its own stream,
#: so two decodes on two streams at once never count into each other's
#: tickets
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def kernel_for(q_dtype: torch.dtype, cache_dtype: torch.dtype) -> str:
    """The kernel a call with q in ``q_dtype`` over a cache in
    ``cache_dtype`` launches: "mma" (both bfloat16) or "fp32"."""
    try:
        return _KERNELS[(q_dtype, cache_dtype)]
    except KeyError:
        raise ValueError(f"dtypes q {q_dtype}, cache {cache_dtype}: the "
                         f"kernels take (q, cache) in "
                         f"{sorted((str(a), str(c)) for a, c in _KERNELS)}"
                         ) from None


def mma_blocks_per_sm(head_dim: int) -> int:
    """Blocks of the mma kernel an SM holds at once: one above head_dim 128
    (256 threads: two sets of 4 warps, each holding half of O's columns;
    a ring of 3 stages of 66 KB at 256, of 42 KB at 160), two at 128 and
    below (128 threads; a ring of 3 stages of 35 KB at 128, 26 KB at 96)."""
    return 1 if head_dim > 128 else 2


def num_splits(b: int, kv: int, s: int, window: Optional[int],
               group: int = 1, head_dim: int = 256,
               kernel: str = "mma") -> int:
    """Blocks per (sequence, KV head), from the shapes only, never ``pos``,
    so that a call captured in a CUDA graph stays valid as ``pos`` moves.

    Enough blocks to fill the card (``TARGET_BLOCKS``; for the mma kernel
    in one wave of the blocks the SMs hold, so that no block waits for
    another to finish), no more than the tiles of the longest live range the
    cache can hold, and, for the mma kernel, no more than keep its merge
    cheap: one block reads every split's fp32 partial (``group`` x head_dim
    floats each), so the splits are held to where those reads are at most
    what a block streams of the longest live range: splits^2 x group x 4
    bytes <= tiles x 64 keys x 4 bytes (a key's K and V rows in bf16),
    splits <= sqrt(64 tiles / group), and to what the merge can stage in
    shared memory at once (``MERGE_BYTES``)."""
    live = min(s, window) if window is not None else s
    tiles = -(-live // TILE)
    if kernel == "mma":
        resident = TARGET_BLOCKS[kernel] * mma_blocks_per_sm(head_dim)
        n = min(resident // (b * kv), math.isqrt(64 * tiles // group),
                MERGE_BYTES // (128 + 4 * group * head_dim))
    else:
        n = -(-TARGET_BLOCKS[kernel] // (b * kv))
    return max(1, min(n, tiles, MAX_SPLITS[kernel]))


def _tickets_for(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed merge counters for the current stream of
    ``device``, made (on that stream) the first time the stream asks; under
    a CUDA graph capture, ``n`` of the graph's own."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * t.numel() if t is not None else 0),
                        dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


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
    build.check_inputs("decode_attention", q, k_cache, v_cache,
                       pos)
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"shapes q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}: need [B,N,H] and [B,S,K,H]")
    b, n, h = q.shape
    _, s, kv, _ = k_cache.shape
    tensors = (q, k_cache, v_cache, pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention kernel needs q, the cache and pos "
                         "as CUDA tensors on one device")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"dtypes k {k_cache.dtype}, v {v_cache.dtype} differ")
    kernel = kernel_for(q.dtype, k_cache.dtype)
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
    if kernel == "fp32" and n // kv == 16 and h > MAX_HEAD_DIM_G16_FP32:
        raise ValueError(f"with float32 q a group of 16 query heads takes "
                         f"head_dim up to {MAX_HEAD_DIM_G16_FP32}, got {h}")
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
    splits = num_splits(b, kv, s, window, n // kv, h, kernel)
    g = n // kv
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "mma":
            part = tickets = None
            if splits > 1:
                part = torch.empty(b * kv * splits * g * (h + 2),
                                   dtype=torch.float32, device=q.device)
                tickets = _tickets_for(q.device, b * kv)
            err = lib.repro_decode_attention_mma_fwd(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None,
                tickets.data_ptr() if tickets is not None else None,
                b, s, n, kv, h, splits, float(scale), window or 0,
                float(softcap or 0.0), stream)
        else:
            part_acc = torch.empty((b, kv, splits, g, h), dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty((b, kv, splits, g, 2), dtype=torch.float32,
                                  device=q.device)
            err = lib.repro_decode_attention_fwd(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
                b, s, n, kv, h, splits, TILE, float(scale), window or 0,
                float(softcap or 0.0), stream)
    build.check(lib, err, f"decode_attention ({kernel}) launch")
    _count(kernel)
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
