"""The AdamW update of one parameter leaf: binding of ``csrc/adamw.cu``.

Replaces no Pallas kernel: the JAX package's update
(``repro/training/optim.py``, ``apply_updates``) is plain ``jnp`` that XLA
fuses under ``jax.jit`` into one pass over each leaf; this kernel is that
fused pass. The CUDA source says what it computes and what bounds it. Its
plain PyTorch version is ``ref.adamw``, which it equals bit for bit;
``ops.adamw`` picks between the two by the device of the tensors (on a mesh,
the kernel runs on each rank's local shards).

A call is one launch and writes p, m and v in place. lr, the bias
corrections and the clip scale stay on the device (one float32 each), so a
CUDA graph that captures the call reads each replay's values.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0


def _count() -> None:
    """One launch (``build.count``)."""
    build.count("adamw", None)


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          lr: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
          scale: Optional[torch.Tensor], *, b1: float, b2: float, eps: float,
          weight_decay: float) -> None:
    """Launch the CUDA kernel on CUDA tensors: p (float32 or bfloat16), g,
    m and v (float32), all contiguous and of one shape, p, m and v updated
    in place; lr, b1c, b2c and ``scale`` (None: no clipping) one float32
    each. Raises on anything the kernel does not take."""
    scalars = dict(lr=lr, b1c=b1c, b2c=b2c)
    if scale is not None:
        scalars["scale"] = scale
    build.check_inputs("adamw", p, g, m, v, *scalars.values())
    if p.dtype not in _DTYPES:
        raise ValueError(f"p dtype {p.dtype} not in {sorted(map(str, _DTYPES))}")
    for name, t in dict(g=g, m=m, v=v, **scalars).items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in dict(g=g, m=m, v=v).items():
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
    for name, t in scalars.items():
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value, has {t.numel()}")
    tensors = (p, g, m, v, *scalars.values())
    if not all(t.is_cuda and t.device == p.device for t in tensors):
        raise ValueError("adamw kernel needs every input as a CUDA tensor on "
                         "one device")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("adamw kernel needs p, g, m and v contiguous (p, m "
                         "and v are written in place)")
    if p.numel() == 0:
        return
    lib = build.load()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_adamw_fwd(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
            _DTYPES[p.dtype], lr.data_ptr(), b1c.data_ptr(), b2c.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, stream)
    build.check(lib, err, "adamw launch")
    _count()


def hbm_bytes(n: int, p_bytes: int) -> int:
    """Bytes one leaf of ``n`` elements needs moved: p read and written, g
    read, m and v read and written (float32), and the four scalars."""
    return n * (2 * p_bytes + 4 + 8 + 8) + 16


def flops(n: int, clip: bool, decay: bool) -> int:
    """Floating-point operations of one leaf: 14 an element, and the clip's
    product and the decay's two where they apply."""
    return n * (14 + int(clip) + 2 * int(decay))
