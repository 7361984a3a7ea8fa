"""Parameter trees between the JAX package and the port.

Both keep the same plain-dict layout: the same names, the same shapes and
``[in, out]`` einsum layouts, and the stacked group axis at the front of
every leaf of ``params["blocks"]``. So a JAX tree converts leaf by leaf.

The same holds for the decode cache: ``from_jax_params`` carries a JAX cache
tree (leaves ``k``, ``v``, ``conv``, ``ssm``, none of them in
``COMPUTE_LEAVES``) across as it is, bfloat16 KV caches included, so both
packages can decode from one cache.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .configs import ArchConfig
from .models import model as M

#: leaves that every apply function casts to the compute dtype before use
#: (weights and biases of the products, the MoE router, the embedding
#: table, the frontend projection, the conv), under whichever subtree they
#: lie (``blocks``, zamba2's ``shared_attn``, ``frontend``); norm scales
#: and the SSM's A_log, D and dt_bias stay float32
COMPUTE_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv",          # attention
    "wi", "wg",                                        # mlp and experts ("wo" above)
    "router",                                          # moe
    "table", "unembed",                                # embedding
    "proj",                                            # frontend stub
    "in_proj", "out_proj", "conv_w", "conv_b",         # mamba2
})


def from_jax_params(tree: dict, device: str | torch.device = "cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Convert a tree of numpy (or JAX) arrays into tensors on ``device``.
    With ``dtype``, the leaves in ``COMPUTE_LEAVES`` are cast to it once:
    the same cast the forward pass makes on every call."""
    dev = resolve_device(device)
    params = M.tree_map(lambda a: _tensor(np.array(a)).to(dev), tree)
    return params if dtype is None else to_compute_dtype(params, dtype)


def _tensor(a: np.ndarray) -> torch.Tensor:
    # numpy has no bfloat16 of its own (JAX's is ml_dtypes'): cross as bits
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_compute_dtype(params: dict, dtype: torch.dtype) -> dict:
    """Cast the leaves in ``COMPUTE_LEAVES`` to ``dtype``, once, for serving."""
    def walk(tree: dict) -> dict:
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in COMPUTE_LEAVES:
                out[name] = leaf.to(dtype)
            else:
                out[name] = leaf
        return out
    return walk(params)


def init_compute_params(gen: torch.Generator, cfg: ArchConfig,
                        device: str | torch.device,
                        dtype: torch.dtype) -> dict:
    """``init_params``' draws with the leaves in ``COMPUTE_LEAVES`` cast to
    ``dtype`` as each layer group is drawn, so no more than one group is
    held in float32 at a time (how a full-width model is built on the
    card)."""
    return M.assemble_params(to_compute_dtype(part, dtype)
                             for part in M.init_parts(gen, cfg, device))
