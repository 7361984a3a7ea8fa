"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

Each wrapper picks the implementation by where the tensors live: on the
CPU it runs the plain PyTorch version from ``ref`` with the JAX package's
padding to tile boundaries, on CUDA it launches the hand-written kernel,
which raises on anything it does not take. The flash kernel masks ragged
sequence ends itself, so only the SSD scan is padded (to its chunk) on
CUDA, and the decode kernel reads only the live rows of the cache, so it is
never padded. Neither version of the grouped matmul is padded. A CUDA
tensor never falls back to the plain version, and no kernel has a backward
pass: on CUDA, an input that requires grad under grad mode raises
(``build.check_inputs``) where the plain version would differentiate, and
so does a DTensor (``build.DTensorInputError``): a kernel reads raw
pointers, and a shard is not the whole tensor. Meta tensors (the dry-run's)
take the plain version, which computes shapes only; the AdamW update on
meta tensors is instead one op, ``torch.ops.repro_torch.adamw`` (its only
kernel is for meta tensors, and does nothing), so that the dry-run counts
it as the card runs it: one pass over p, g, m and v, on each rank's
shards.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from . import adamw as _adamw
from . import decode_attention as _dec
from . import flash_attention as _fa
from . import gmm as _gmm
from . import mamba_front as _front
from . import ref
from . import ssd as _ssd


#: the AdamW kernel's launch as one op on meta tensors: p, m and v written
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("adamw(Tensor(a!) p, Tensor g, Tensor(b!) m, Tensor(c!) v, "
            "Tensor lr, Tensor b1c, Tensor b2c, Tensor? scale, float b1, "
            "float b2, float eps, float weight_decay) -> ()")
_LIB.impl("adamw", lambda *args: None, "Meta")


def _pad_seq(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]   # F.pad counts from the last dim
    return F.pad(x, widths)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernel), False for CPU or meta tensors
    (the plain version; meta, which the dry-run asks for, carries shapes
    only). Mixed devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"meta"}):
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     f"tensors and their plain versions CPU (or meta) "
                     f"tensors")


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


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    pos: torch.Tensor, *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    block_k: int = _dec.DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """[B, N, H] x cache [B, S, K, H]^2 -> [B, N, H], keys up to ``pos``.

    ``block_k`` sets the padding of the plain version, as the JAX package's
    tile size does (padded keys lie past every ``pos``); the CUDA kernel
    keeps its own tiles and masks the ragged end itself.
    """
    if _on_cuda(q, k_cache, v_cache, pos):
        return _dec.decode_attention(q, k_cache, v_cache, pos, scale=scale,
                                     window=window, softcap=softcap)
    bk = min(block_k, k_cache.shape[1])
    return ref.decode_attention(q, _pad_seq(k_cache, 1, bk),
                                _pad_seq(v_cache, 1, bk), pos, scale=scale,
                                window=window, softcap=softcap)


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


def mamba_front(zxbcdt: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor, dt_bias: torch.Tensor, *, xbc_at: int,
                dt_at: int, state: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Mamba2's front, in_proj's output [B, S, width] to the SSD scan's
    inputs (x [B,S,H,P], B, C [B,S,N] and dt [B,S,H]; see
    ``ref.mamba_front``): the kernel on CUDA tensors, which reads zxbcdt in
    place, the plain version on CPU and meta tensors."""
    kw = dict(xbc_at=xbc_at, dt_at=dt_at, state=state)
    if _on_cuda(zxbcdt, conv_w, conv_b, dt_bias):
        return _front.mamba_front(zxbcdt, conv_w, conv_b, dt_bias, **kw)
    return ref.mamba_front(zxbcdt, conv_w, conv_b, dt_bias, **kw)


def gmm(x_sorted: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        *, block_t: int = 128, block_f: int = 512) -> torch.Tensor:
    """Ragged grouped matmul [T, D] x [E, D, F] -> [T, F]: rows sorted by
    group, ``group_sizes`` [E] rows each (summing to T).

    ``block_t`` and ``block_f`` are the JAX package's tile sizes and set
    nothing here: the CUDA kernel keeps its own tiles, and the plain version
    needs no padding, since a padding row only adds an output row that the
    JAX package drops again and changes no real row.
    """
    del block_t, block_f
    if _on_cuda(x_sorted, w, group_sizes):
        return _gmm.gmm(x_sorted, w, group_sizes)
    return ref.gmm(x_sorted, w, group_sizes)


def _shard(x: torch.Tensor, like: torch.Tensor, name: str,
           move: bool = False) -> torch.Tensor:
    """The rank's local shard of a DTensor ``x`` placed as ``like`` (with
    ``move``, redistributed there first; else its placements must already
    be ``like``'s); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    if x.placements != like.placements:
        if not move:
            raise ValueError(f"adamw: {name} placed {x.placements}, p "
                             f"{like.placements}")
        x = x.redistribute(like.device_mesh, like.placements)
    return x.to_local()


def _whole(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A scalar DTensor's value on this rank (``full_tensor``)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          *, lr: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
          scale: Optional[torch.Tensor], b1: float, b2: float, eps: float,
          weight_decay: float) -> None:
    """One leaf's AdamW update, in place on p, m and v (see ``ref.adamw``):
    the kernel on CUDA tensors, the plain version on CPU tensors, and on
    meta tensors (the dry-run) one ``repro_torch::adamw`` op, as the
    kernel's launch. On a mesh (DTensors) each runs on each rank's local
    shards of p, m and v (placed alike), with g redistributed to p's
    placements, and reads each rank's copy of the scalars."""
    p_, m_, v_ = (_shard(x, p, n) for x, n in ((p, "p"), (m, "m"),
                                                (v, "v")))
    g_ = _shard(g, p, "g", move=True)
    s_ = [_whole(x) for x in (lr, b1c, b2c, scale)]
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if p_.device.type == "meta":
        torch.ops.repro_torch.adamw(p_, g_.contiguous(), m_, v_, *s_, **kw)
    elif _on_cuda(p_, g_, m_, v_, *(x for x in s_ if x is not None)):
        # a gradient from autograd may be strided; the kernel reads it flat
        _adamw.adamw(p_, g_.contiguous(), m_, v_, *s_, **kw)
    else:
        ref.adamw(p_, g_, m_, v_, *s_, **kw)
