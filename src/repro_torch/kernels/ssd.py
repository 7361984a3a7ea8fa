"""Mamba2 SSD chunked scan: binding of ``csrc/ssd.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py`` (``ssd``). The CUDA
source says how it is laid out and what bounds it. Its plain PyTorch version
is ``ref.ssd_chunked`` (``ref.ssd`` is the sequential definition);
``ops.ssd`` pads the sequence with dt = 0 and picks between them by the
device of the tensors.
"""
from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def ssd(
    x: torch.Tensor,             # [B, S, H, P]  float32 or bfloat16
    dt: torch.Tensor,            # [B, S, H]     float32 (softplus'd)
    A: torch.Tensor,             # [H]           float32 (negative)
    B: torch.Tensor,             # [B, S, N]     float32
    C: torch.Tensor,             # [B, S, N]     float32
    D: torch.Tensor,             # [H]           float32
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors. S must be a multiple of
    ``chunk``. Returns (y [B,S,H,P] in x's dtype, final state [B,H,N,P]
    float32)."""
    global launches
    b, s, h, p = x.shape
    n = B.shape[-1]
    tensors = dict(x=x, dt=dt, A=A, B=B, C=C, D=D)
    if not all(t.is_cuda and t.device == x.device for t in tensors.values()):
        raise ValueError("ssd kernel needs all inputs as CUDA tensors on one "
                         "device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x dtype {x.dtype} not in {sorted(map(str, _DTYPES))}")
    for name in ("dt", "A", "B", "C", "D"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {tensors[name].dtype}")
    want = dict(dt=(b, s, h), A=(h,), B=(b, s, n), C=(b, s, n), D=(h,))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    x, dt, A, B, C, D = (t.contiguous() for t in (x, dt, A, B, C, D))
    y = torch.empty_like(x)
    fin = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    # C.B^T of every chunk, made once for all heads by the first kernel
    cb = torch.empty((b, s // chunk, chunk, chunk), dtype=torch.float32,
                     device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), fin.data_ptr(),
            cb.data_ptr(), _DTYPES[x.dtype], b, s, h, p, n, chunk, stream)
    build.check(lib, err, "ssd launch")
    launches += 1
    return y, fin


def flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """Floating-point operations the chunked scan needs, 2 per multiply-add:
    C.B^T over the j <= i half of each chunk (once: B and C are shared by
    the heads), and per head G@x over that half, C@state and the state
    update over every position."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    per_head = tri * p + 2 * chunk * n * p
    return 2 * b * nc * (tri * n + h * per_head)
