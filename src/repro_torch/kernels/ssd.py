"""Mamba2 SSD chunked scan: binding of ``csrc/ssd.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py`` (``ssd``). The CUDA
source says how it is laid out and what bounds it. Its plain PyTorch version
is ``ref.ssd_chunked`` (``ref.ssd`` is the sequential definition);
``ops.ssd`` pads the sequence with dt = 0 and picks between them by the
device of the tensors.

A call launches the source's three kernels in order (the chunks' local
states, with C.B^T per chunk in its first blocks; the pass over the chunks;
the output); ``launches`` counts calls. That each call runs the three is
checked by the profiler's kernel names, which a counter raised after one C
call cannot show.
"""
from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the longest chunk the kernels take: the output kernel's two blocks of two
#: warpgroups, a 64-row tile each, cover a chunk's rows. A longer chunk runs
#: as equal sub-chunks, which is the same scan (the chunked form is exact for
#: any partition of the sequence).
MAX_CHUNK = 256

#: calls that launched the CUDA kernels since the last reset (set to 0 to reset)
launches = 0


def _count() -> None:
    """One call's launches (``build.count``)."""
    build.count("ssd", None)


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
    """Launch the CUDA kernels on CUDA tensors. S must be a multiple of
    ``chunk``. Returns (y [B,S,H,P] in x's dtype, final state [B,H,N,P]
    float32)."""
    build.check_inputs("ssd", x, dt, A, B, C, D)
    b, s, h, p = x.shape
    n = B.shape[-1]
    tensors = dict(x=x, dt=dt, A=A, B=B, C=C, D=D)
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
    if n > 256:
        raise ValueError(f"ssd kernel takes a state of at most 256, got {n}")
    if not all(t.is_cuda and t.device == x.device for t in tensors.values()):
        raise ValueError("ssd kernel needs all inputs as CUDA tensors on one "
                         "device")
    parts = -(-chunk // MAX_CHUNK)
    while chunk % parts:
        parts += 1
    chunk //= parts
    nc = s // chunk
    # the kernels take a chunk of a multiple of 64 positions, N a multiple of
    # 64 (up to 256) and P of 8. Other shapes are padded exactly: positions
    # appended to each chunk with dt = 0 change no state and their outputs are
    # dropped, and zero columns of B, C and x add nothing.
    lp, np_, pp = -(-chunk // 64) * 64, -(-n // 64) * 64, -(-p // 8) * 8
    padded = (lp, np_, pp) != (chunk, n, p)
    if padded:
        x = _pad_chunks(x, nc, chunk, lp, (h, pp))
        dt = _pad_chunks(dt, nc, chunk, lp, (h,))
        B = _pad_chunks(B, nc, chunk, lp, (np_,))
        C = _pad_chunks(C, nc, chunk, lp, (np_,))
    x, dt, A, B, C, D = (_aligned(t) for t in (x, dt, A, B, C, D))
    y = torch.empty_like(x)
    fin = torch.empty((b, h, np_, pp), dtype=torch.float32, device=x.device)
    # scratch: C.B^T of every chunk (made once for all heads); each chunk's
    # local state and total decay; the state entering each chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((b, nc, lp, lp), **f32)
    local = torch.empty((b, nc, h, np_, pp), **f32)
    entering = torch.empty((b, nc, h, np_, pp), **f32)
    decays = torch.empty((b, nc, h), **f32)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), fin.data_ptr(),
            cb.data_ptr(), local.data_ptr(), entering.data_ptr(),
            decays.data_ptr(), _DTYPES[x.dtype], b, nc * lp, h, pp, np_, lp,
            stream)
    build.check(lib, err, "ssd launch")
    _count()
    if padded:
        y = y.reshape(b, nc, lp, h, pp)[:, :, :chunk, :, :p].reshape(b, s, h, p)
        fin = fin[:, :, :n, :p].contiguous()
    return y, fin


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, from a 16-byte aligned base."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_chunks(t: torch.Tensor, nc: int, chunk: int, lp: int,
                rest: tuple[int, ...]) -> torch.Tensor:
    """[B, nc * chunk, *r] -> [B, nc * lp, *rest]: each chunk's positions,
    then zeros to lp; each trailing dim zero-padded to ``rest``."""
    b = t.shape[0]
    out = t.new_zeros((b, nc, lp) + rest)
    src = t.reshape((b, nc, chunk) + tuple(t.shape[2:]))
    out[(slice(None), slice(None), slice(0, chunk))
        + tuple(slice(0, r) for r in t.shape[2:])] = src
    return out.reshape((b, nc * lp) + rest)


def flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """Floating-point operations the chunked scan needs, 2 per multiply-add:
    C.B^T over the j <= i half of each chunk (once: B and C are shared by
    the heads), and per head G@x over that half, C@state and the state
    update over every position."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    per_head = tri * p + 2 * chunk * n * p
    return 2 * b * nc * (tri * n + h * per_head)
