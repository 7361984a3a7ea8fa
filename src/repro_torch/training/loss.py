"""Loss functions: next-token cross entropy with z-loss and the MoE aux
loss (port of ``repro/training/loss.py``).

On a mesh the logits arrive as a DTensor, their vocab axis possibly
sharded; the target gather takes them with the vocab whole
(``placement.whole``): DTensor's gather along a sharded dimension gives a
wrong shape."""
from __future__ import annotations

from typing import Optional

import torch

from ..placement import whole

Tensor = torch.Tensor

IGNORE = -1  # label value excluded from the loss


def cross_entropy(logits: Tensor, labels: Tensor, *,
                  z_loss: float = 1e-4) -> tuple[Tensor, dict[str, Tensor]]:
    """Token-mean CE. logits: [B, S, V] (fp32), labels: [B, S] int.

    z-loss (log^2 Z regularizer) keeps the softmax normalizer bounded in
    bf16 training. Every metric is over max(mask.sum(), 1) tokens.
    """
    logits = whole(logits, -1).float()
    mask = (labels != IGNORE).float()
    safe = labels.clamp_min(0).long()
    lz = torch.logsumexp(logits, dim=-1)                        # [B, S]
    tgt = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lz - tgt) * mask
    zl = z_loss * torch.square(lz) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = (nll + zl).sum() / denom
    metrics = {
        "nll": nll.sum() / denom,
        "z_loss": zl.sum() / denom,
        "tokens": mask.sum(),
        "accuracy": ((logits.argmax(-1) == labels) * mask).sum() / denom,
    }
    return loss, metrics


def lm_loss(logits: Tensor, labels: Tensor, aux: Optional[Tensor] = None,
            aux_weight: float = 1e-2, z_loss: float = 1e-4
            ) -> tuple[Tensor, dict[str, Tensor]]:
    loss, metrics = cross_entropy(logits, labels, z_loss=z_loss)
    if aux is not None:
        loss = loss + aux_weight * aux
        metrics["moe_aux"] = aux
    metrics["loss"] = loss
    return loss, metrics
