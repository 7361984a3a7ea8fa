"""Mamba2's front, from in_proj's rows to the SSD scan's inputs: binding of
``csrc/mamba_front.cu``.

Replaces no Pallas kernel: the JAX package's front (the causal conv, its
bias, SiLU, the split of x, B and C, and dt's softplus in
``repro/models/ssm.py``) is plain ``jnp`` that XLA fuses under ``jax.jit``;
this kernel is that fused pass. The CUDA source says what it computes and
what bounds it. Its plain PyTorch version is ``ref.mamba_front``;
``ops.mamba_front`` picks between the two by the device of the tensors.

A call is one launch. It reads ``zxbcdt`` in place, through its batch and
row strides, and writes x, B, C and dt as the contiguous buffers that the
SSD binding takes without a copy.
"""
from __future__ import annotations

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the causal conv's taps, the only width the kernel takes
TAPS = 4

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def _count() -> None:
    """One launch (``build.count``)."""
    build.count("mamba_front", None)


def mamba_front(zxbcdt: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor, dt_bias: torch.Tensor, *, xbc_at: int,
                dt_at: int, state: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors: ``zxbcdt`` [B, S, width]
    (float32 or bfloat16) with (x|B|C) at ``xbc_at`` and dt at ``dt_at`` of
    each row; ``conv_w`` [4, C] and ``conv_b`` [C] in float32 or zxbcdt's
    dtype, ``dt_bias`` [H] float32, C = d_inner + 2 ``state``. Returns (x
    [B, S, H, P] in zxbcdt's dtype, B and C [B, S, state] and dt [B, S, H]
    float32). Raises on anything the kernel does not take."""
    build.check_inputs("mamba_front", zxbcdt, conv_w, conv_b, dt_bias)
    dtype = zxbcdt.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"zxbcdt dtype {dtype} not in "
                         f"{sorted(map(str, _DTYPES))}")
    for name, t in (("conv_w", conv_w), ("conv_b", conv_b)):
        if t.dtype not in (torch.float32, dtype):
            raise ValueError(f"{name} dtype {t.dtype}: float32 or zxbcdt's "
                             f"{dtype}")
    if conv_b.dtype != conv_w.dtype:
        raise ValueError(f"conv_b dtype {conv_b.dtype}, conv_w "
                         f"{conv_w.dtype}")
    if dt_bias.dtype != torch.float32:
        raise ValueError(f"dt_bias must be float32, got {dt_bias.dtype}")
    if zxbcdt.ndim != 3 or conv_w.ndim != 2:
        raise ValueError(f"zxbcdt {tuple(zxbcdt.shape)} and conv_w "
                         f"{tuple(conv_w.shape)}: need [B, S, width] and "
                         f"[K, C]")
    b, s, width = zxbcdt.shape
    k, c = conv_w.shape
    h = dt_bias.shape[0]
    d_inner = c - 2 * state
    if k != TAPS:
        raise ValueError(f"the kernel takes {TAPS} conv taps, got {k}")
    if tuple(conv_b.shape) != (c,) or dt_bias.ndim != 1:
        raise ValueError(f"conv_b {tuple(conv_b.shape)} and dt_bias "
                         f"{tuple(dt_bias.shape)}: need [{c}] and [H]")
    if state < 1 or d_inner < 1 or d_inner % h:
        raise ValueError(f"{c} channels less 2 x state {state} leave "
                         f"{d_inner}, not a positive multiple of {h} heads")
    if d_inner % 2 or state % 2:     # the kernel's threads own channel pairs
        raise ValueError(f"d_inner {d_inner} and state {state} must be even")
    if b * s == 0:
        raise ValueError(f"zxbcdt {tuple(zxbcdt.shape)} holds no position")
    if not 0 <= xbc_at <= width - c:
        raise ValueError(f"xbc offset {xbc_at} + {c} channels out of a row "
                         f"of {width}")
    if not 0 <= dt_at <= width - h:
        raise ValueError(f"dt offset {dt_at} + {h} heads out of a row of "
                         f"{width}")
    sb, ss, sc = zxbcdt.stride()
    if sc != 1:
        raise ValueError(f"zxbcdt strides {zxbcdt.stride()}: the kernel "
                         f"reads a row's channels at stride 1")
    # the kernel loads a pair of channels as one word
    for what, n in (("address", zxbcdt.data_ptr() // zxbcdt.element_size()),
                    ("row stride", ss), ("batch stride", sb if b > 1 else 0),
                    ("xbc offset", xbc_at)):
        if n % 2:
            raise ValueError(f"zxbcdt's {what} is not a multiple of a pair "
                             f"of values")
    if not all(t.is_contiguous() and t.data_ptr() % (2 * t.element_size()) == 0
               for t in (conv_w, conv_b)) or not dt_bias.is_contiguous():
        raise ValueError("conv_w, conv_b and dt_bias must be contiguous, "
                         "conv_w and conv_b aligned to a pair of values")
    tensors = (zxbcdt, conv_w, conv_b, dt_bias)
    if not all(t.is_cuda and t.device == zxbcdt.device for t in tensors):
        raise ValueError("mamba_front kernel needs every input as a CUDA "
                         "tensor on one device")
    dev = zxbcdt.device
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.empty((b, s, h, d_inner // h), dtype=dtype, device=dev)
    bmat = torch.empty((b, s, state), **f32)
    cmat = torch.empty((b, s, state), **f32)
    dt = torch.empty((b, s, h), **f32)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_mamba_front_fwd(
            zxbcdt.data_ptr(), sb, ss, xbc_at, dt_at, conv_w.data_ptr(),
            conv_b.data_ptr(), dt_bias.data_ptr(), x.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(), _DTYPES[dtype],
            _DTYPES[conv_w.dtype], b, s, d_inner, state, h, k, stream)
    build.check(lib, err, "mamba_front launch")
    _count()
    return x, bmat, cmat, dt


def hbm_bytes(b: int, s: int, d_inner: int, n: int, h: int, esize: int,
              w_esize: int) -> int:
    """Bytes one launch needs moved: the (x|B|C) and dt slices of each row
    read, x written in the compute dtype (``esize`` bytes), B, C and dt
    written in float32, the weights and biases read once (conv_w and conv_b
    of ``w_esize`` bytes, dt_bias float32)."""
    c = d_inner + 2 * n
    rows = b * s * ((c + h) * esize + d_inner * esize + (2 * n + h) * 4)
    return rows + (TAPS + 1) * c * w_esize + 4 * h
