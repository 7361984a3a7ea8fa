"""Optimizer substrate: AdamW with decoupled weight decay, global-norm
clipping, and warmup+cosine schedules (port of ``repro/training/optim.py``).

State layout mirrors the param tree (m, v per leaf, fp32) plus a scalar
int32 step, so the checkpoint manager treats optimizer state exactly like
parameters.

The reference's update is functional (new m, v and params beside the old
ones). Here ``apply_updates`` writes m, v and the params in place, leaf by
leaf, with the same arithmetic in the same order: at gemma2-2b's 2.6 B
parameters a second copy of the three would not fit on one 80 GB card beside
the gradients. Each leaf's update is ``kernels.ops.adamw``: on the card one
launch of the hand-written kernel (``kernels/csrc/adamw.cu``), the pass XLA
fuses under ``jax.jit``; on the CPU and on meta tensors its plain version
(``kernels.ref.adamw``). lr, the bias corrections and the clip scale stay
on the device, so a captured step reads each step's values. The two global
norms stay torch reductions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..kernels import ops as kops
from ..placement import on_mesh_of
from ..models.model import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def lr_at(cfg: OptimConfig, step: Tensor) -> Tensor:
    """Linear warmup then cosine decay to min_lr_frac * peak, in float32
    tensors as the reference computes it."""
    step = step.float()
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_state(params: Any) -> dict:
    """Zero m and v shaped (and, on a mesh, placed) like the params, and a
    zero step."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    first = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"m": zeros,
            "v": tree_map(torch.clone, zeros),
            "step": on_mesh_of(first, step)}


def state_axes(param_axes_tree: Any) -> dict:
    """Optimizer-state logical axes: m and v shard like their parameters."""
    return {"m": param_axes_tree,
            "v": tree_map(lambda a: a, param_axes_tree),
            "step": ()}


def global_norm(tree: Any) -> Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _is_matrix(p: Tensor) -> bool:
    return p.ndim >= 2  # decay only matrices (norms/biases/scalars exempt)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, cfg: OptimConfig,
                  compress: Optional[Callable[[Any], Any]] = None,
                  ) -> tuple[Any, dict, dict[str, Tensor]]:
    """One AdamW step, in place on ``params`` and ``state`` (``grads`` are
    read, not written). Returns (params, state, metrics): the same trees."""
    grads = tree_map(lambda g: g.float(), grads)
    if compress is not None:
        grads = compress(grads)
    gnorm = global_norm(grads)
    scale = (_clip_scale(gnorm, cfg.clip_norm)
             if cfg.clip_norm is not None else None)
    step = state["step"].add_(1)
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        kops.adamw(p, g, m, v, lr=lr, b1c=b1c, b2c=b2c, scale=scale,
                   b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                   weight_decay=cfg.weight_decay if _is_matrix(p) else 0.0)
    metrics = {"lr": lr, "grad_norm": gnorm,
               "param_norm": global_norm(params)}
    return params, state, metrics
