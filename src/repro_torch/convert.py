"""Parameter trees between the JAX package and the port.

Both keep the same plain-dict layout: the same names, the same shapes and
``[in, out]`` einsum layouts, and the stacked group axis at the front of
every leaf of ``params["blocks"]``. So a JAX tree converts leaf by leaf.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .models.model import tree_map

#: leaves that every apply function casts to the compute dtype before use
#: (weights and biases of the products, the embedding table, the conv);
#: norm scales and the SSM's A_log, D and dt_bias stay float32
COMPUTE_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv",          # attention
    "wi", "wg",                                        # mlp ("wo" above)
    "table", "unembed",                                # embedding
    "in_proj", "out_proj", "conv_w", "conv_b",         # mamba2
})


def from_jax_params(tree: dict, device: str | torch.device = "cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Convert a tree of numpy (or JAX) arrays into tensors on ``device``.
    With ``dtype``, the leaves in ``COMPUTE_LEAVES`` are cast to it once:
    the same cast the forward pass makes on every call."""
    dev = resolve_device(device)
    params = tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)
    return params if dtype is None else to_compute_dtype(params, dtype)


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
