"""The served models' weights, made by the benchmark from ``--seed`` on the
device, in the type they are served in.

All leaves of a configuration lie in two flat buffers, one in the compute
dtype and one in float32, each drawn by a few large normal draws of a
``torch.Generator`` on the device; each leaf is a view into its buffer at a
256-byte aligned offset, reshaped and rescaled in place to its kind:

* ``dense``: N(0, 1 / fan_in); ``embed``: N(0, 1);
* ``bias``: N(0, 0.2^2); ``conv_w``, ``conv_b``: N(0, 0.1^2);
* ``norm`` (the RMSNorm's ``scale`` of ``1 + scale``) and ``D`` (the
  state space's skip): N(0, 0.1^2). A skip near 0, where Mamba2 starts
  at 1, leaves the scan's output, and so the state carried from chunk to
  chunk, most of the block's output: with a skip near 1 a scan that drops
  that state reads within rounding of a sound one;
* ``A_log``: log of a uniform on [1, 16];
  ``dt_bias``: the inverse softplus of a log-uniform on [1e-3, 0.1]
  (Mamba2's), the uniforms taken from the normal draw through its CDF.

The leaves of a model are its reference module's ``param_layout``
(``harness.references``); the kinds served in the compute dtype are the
module's ``COMPUTE_KINDS``, ``reference.model``'s where it defines none, so
that a module may keep a kind, such as a router's correction bias, in
float32. Both sides, the program and the reference, are handed the same
views.
``refill`` draws a new seed into the same buffers, so that whatever baked
in their addresses stays valid.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import ModuleType

import torch

from .reference.model import COMPUTE_KINDS

#: elements a leaf's offset is rounded up to (256 bytes in bfloat16)
ALIGN = 128
#: elements of one draw
DRAW = 1 << 28


@dataclass
class Leaf:
    model: str
    path: tuple[str, ...]
    shape: tuple[int, ...]
    kind: str
    fan_in: int
    offset: int
    compute: bool

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclass
class Weights:
    """Both buffers, every leaf, and each model's tree of views."""

    compute: torch.Tensor
    fp32: torch.Tensor
    leaves: list[Leaf]
    trees: dict[str, dict]

    @property
    def nbytes(self) -> int:
        return (self.compute.numel() * self.compute.element_size()
                + self.fp32.numel() * 4)


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def plan(models: dict[str, dict], refs: dict[str, ModuleType]
         ) -> tuple[list[Leaf], int, int]:
    """Every leaf of ``models`` ({name: config entry}) with its offset in
    its buffer, and the two buffers' lengths; each model's leaves from its
    reference module in ``refs`` ({name: module}), in the compute buffer
    where the module's ``COMPUTE_KINDS`` (``reference.model``'s where it
    defines none) hold its kind."""
    leaves, ends = [], {True: 0, False: 0}
    for name, cfg in models.items():
        kinds = getattr(refs[name], "COMPUTE_KINDS", COMPUTE_KINDS)
        for path, shape, kind, fan_in in refs[name].param_layout(cfg):
            compute = kind in kinds
            leaf = Leaf(name, path, tuple(shape), kind, fan_in,
                        ends[compute], compute)
            ends[compute] = _aligned(ends[compute] + leaf.numel)
            leaves.append(leaf)
    return leaves, ends[True], ends[False]


def _normal_(buf: torch.Tensor, gen: torch.Generator) -> None:
    for start in range(0, buf.numel(), DRAW):
        buf[start:start + DRAW].normal_(generator=gen)


def _shape_leaf(v: torch.Tensor, leaf: Leaf) -> None:
    """Turn a N(0, 1) view into the leaf's kind, in place."""
    k = leaf.kind
    if k == "dense":
        v.mul_(1.0 / math.sqrt(leaf.fan_in))
    elif k == "bias":
        v.mul_(0.2)
    elif k in ("conv_w", "conv_b", "norm", "D"):
        v.mul_(0.1)
    elif k in ("A_log", "dt_bias"):
        u = 0.5 * (1.0 + torch.erf(v / math.sqrt(2.0)))
        if k == "A_log":
            v.copy_(torch.log1p(15.0 * u))
        else:
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            v.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif k != "embed":
        raise ValueError(f"unknown leaf kind {k!r}")


def _draw(w: Weights, seed: int) -> None:
    gen = torch.Generator(device=w.compute.device).manual_seed(seed)
    _normal_(w.compute, gen)
    _normal_(w.fp32, gen)
    for leaf in w.leaves:
        buf = w.compute if leaf.compute else w.fp32
        _shape_leaf(buf[leaf.offset:leaf.offset + leaf.numel], leaf)


def make(models: dict[str, dict], refs: dict[str, ModuleType], seed: int,
         device: torch.device, dtype: torch.dtype = torch.bfloat16
         ) -> Weights:
    """The weights of ``models`` drawn from ``seed`` on ``device``, laid
    out as ``plan`` lays them."""
    leaves, n_compute, n_fp32 = plan(models, refs)
    compute = torch.empty(n_compute, dtype=dtype, device=device)
    fp32 = torch.empty(n_fp32, dtype=torch.float32, device=device)
    trees: dict[str, dict] = {name: {} for name in models}
    for leaf in leaves:
        buf = compute if leaf.compute else fp32
        node = trees[leaf.model]
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = buf[leaf.offset:leaf.offset
                                  + leaf.numel].view(leaf.shape)
    w = Weights(compute, fp32, leaves, trees)
    _draw(w, seed)
    return w


def refill(w: Weights, seed: int) -> None:
    """Draw ``seed`` into the same buffers (every view keeps its address)."""
    _draw(w, seed)

