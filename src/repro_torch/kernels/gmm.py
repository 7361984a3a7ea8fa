"""Grouped matmul for the MoE expert products: binding of ``csrc/gmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/gmm.py`` (``gmm_padded``,
called by ``gmm``). The CUDA source says how it is laid out and what bounds
it. Its plain PyTorch version is ``ref.gmm``; ``ops.gmm`` picks between the
two by the device of the tensors.

The kernel takes the sorted rows as they are and the group sizes on the
device, so nothing here pads, copies the weights or reads a size back to
the host: a call costs the MoE layer no host sync.

The source holds three kernels: bfloat16 runs the Hopper kernel (wgmma on
TMA-loaded tiles), with D split over several blocks (``splits_for``) when
there are at most ``SPLIT_MAX_ROWS`` rows, as at decode; float32 runs the
CUDA-core kernel. ``kernel_for`` names the one a call takes and
``kernel_launches`` counts each.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the bf16 kernel splits D over blocks up to this many rows (decode)
SPLIT_MAX_ROWS = 64
_BN, _BK = 256, 64          # the bf16 kernel's column tile and depth step
_SPLIT_BLOCKS = 264         # blocks a split aims at: two waves on an H100
_SPLIT_MIN_DEPTH = 4        # depth steps of 64 a split keeps at least

#: launches of the CUDA kernels since the last reset (set to 0 to reset)
launches = 0
#: the same launches by kernel (see ``kernel_for``; reset by assigning zeros)
kernel_launches = {"wgmma": 0, "wgmma_splitk": 0, "fp32": 0}


def _count(kernel: str) -> None:
    """One launch of ``kernel`` (``build.count``)."""
    build.count("gmm", kernel)


def kernel_for(dtype: torch.dtype, t: int) -> str:
    """Which kernel of ``csrc/gmm.cu`` a call of ``t`` rows in ``dtype``
    launches: "wgmma" (bfloat16), "wgmma_splitk" (bfloat16 at up to
    ``SPLIT_MAX_ROWS`` rows) or "fp32"."""
    if dtype == torch.bfloat16:
        return "wgmma_splitk" if t <= SPLIT_MAX_ROWS else "wgmma"
    if dtype == torch.float32:
        return "fp32"
    raise ValueError(f"no gmm kernel for {dtype}")


def splits_for(t: int, d: int, f: int) -> int:
    """How many blocks share each tile's depth D on the split path: enough
    that the at most t live tiles x ceil(F / 256) column tiles give about
    two waves of blocks (one block fits an SM), each keeping at least 4
    steps of 64 (and every split a step). 1 past ``SPLIT_MAX_ROWS`` rows."""
    if t > SPLIT_MAX_ROWS:
        return 1
    n_k = -(-d // _BK)
    tiles = max(t, 1) * -(-f // _BN)
    want = max(1, min(-(-_SPLIT_BLOCKS // tiles), n_k // _SPLIT_MIN_DEPTH))
    per = -(-n_k // want)
    return -(-n_k // per)


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: x [T, D] sorted by group,
    w [E, D, F], group_sizes [E] int (summing to T). Returns [T, F] in x's
    dtype. Raises on anything the kernel does not take."""
    build.check_inputs("gmm", x, w, group_sizes)
    if x.ndim != 2 or w.ndim != 3 or group_sizes.ndim != 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}: need [T,D], "
                         f"[E,D,F] and [E]")
    t, d = x.shape
    e, _, f = w.shape
    if w.shape[1] != d or group_sizes.shape[0] != e:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)} do not match")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes x {x.dtype}, w {w.dtype}: need one of "
                         f"{sorted(map(str, _DTYPES))} for both")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"group_sizes must be int32 or int64, got "
                         f"{group_sizes.dtype}")
    if d % 8 or f % 8:
        raise ValueError(f"D {d} and F {f} must be multiples of 8 (the kernel "
                         f"reads rows in 16-byte chunks)")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("w must be contiguous and 16-byte aligned (the "
                         "kernel does not copy the weights)")
    kernel = kernel_for(x.dtype, t)
    if not all(a.is_cuda and a.device == x.device
               for a in (x, w, group_sizes)):
        raise ValueError("gmm kernel needs x, w and group_sizes as CUDA "
                         "tensors on one device")
    split = kernel == "wgmma_splitk"
    splits = splits_for(t, d, f) if split else 1
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    partial = (torch.empty((splits, t, f), dtype=torch.float32,
                           device=x.device) if split else None)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_gmm_fwd(x.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                                out.data_ptr(),
                                partial.data_ptr() if partial is not None
                                else None,
                                _DTYPES[x.dtype], t, d, f, e, splits, stream)
    build.check(lib, err, "gmm launch")
    _count(kernel)
    return out


def hbm_bytes(group_sizes: Sequence[int], d: int, f: int,
              elem_bytes: int) -> int:
    """Bytes the inputs need moved: the weights of each expert that has a
    row, read once (an expert with none needs nothing read), the rows read
    and the output written once, and the sizes."""
    live = sum(1 for n in group_sizes if n)
    t = sum(group_sizes)
    return (live * d * f + t * d + t * f) * elem_bytes + 4 * len(group_sizes)


def flops(t: int, d: int, f: int) -> int:
    """One [D] x [D, F] product a row, 2 per multiply-add."""
    return 2 * t * d * f
