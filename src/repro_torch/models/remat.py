"""Rematerialisation of a layer group: the counterpart of the JAX package's
``jax.checkpoint`` over ``forward``'s group body with
``jax.checkpoint_policies`` (``repro/models/model.py``, ``cfg.remat``).

``checkpointed(fn, policy)`` wraps ``fn`` in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
forward keeps its autograd graph, and the backward regenerates the tensors
the policy did not save by running ``fn`` again. The gradients are those
of the plain run bit for bit: the graph, and so the order in which
gradients are summed, is the same, and the recompute repeats the same ops
on the same inputs. The policies:

* ``"none"``: no checkpoint, ``fn`` itself;
* ``"full"`` (``nothing_saveable``): nothing is saved but the group's
  inputs; the recompute stops once the last tensor the backward needs is
  regenerated (``torch.utils.checkpoint``'s early stop), so a group that
  ends in a matmul whose output nothing saves does not run it again, as
  XLA drops the same dead recompute;
* ``"dots"`` (``checkpoint_dots``): every matmul's output is saved
  (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``), everything else is
  recomputed;
* ``"dots_nobatch"`` (``checkpoint_dots_with_no_batch_dims``): only the
  matmuls with no batch dimension are saved (the projections and the MLP),
  and the batched ones are recomputed: the attention scores [B, N, S, S],
  the PV product, the MoE einsum's per-expert product and the SSD chunk
  einsums.

``torch.einsum`` hides the batch dimension: ``"bsd,df->bsf"`` reaches
``aten.bmm`` with a batch of 1, ``"bqnh,bknh->bnqk"`` with a batch of
B * N, and ``x @ w`` reaches ``aten.mm``. So a matmul is classed by its
shapes, not its name: ``mm``, ``addmm``, and ``bmm`` / ``baddbmm`` whose
batch is 1 have no batch dimension. A batched contraction whose batch
happens to be 1 (B * N = 1, or a rank whose local batch and heads are one
each on a mesh, where the policy sees the local shapes of the ops
``placement.per_shard`` runs) is read as a projection and saved.

Where the port's ops differ from the reference's, the saved set differs
with them: the MoE dispatch and combine, einsums (dots) in the reference,
are a scatter and a gather in the port (``models.moe``), so "dots"
recomputes them where XLA saves them. Values are the same either way; the
memory differs by their outputs. The depthwise conv of the SSD block is a
convolution in both and is recomputed under "dots" in both.

The forward has no random op, so the checkpoint neither saves nor restores
an RNG state (``preserve_rng_state=False``): saving it reads the CUDA
generator's state, which a CUDA graph capture forbids.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("none", "full", "dots", "dots_nobatch")

_ATEN = torch.ops.aten
#: matmuls, and the argument holding the [batch, n, k] operand of each
_MATMULS = {_ATEN.mm: None, _ATEN.addmm: None, _ATEN.bmm: 0,
            _ATEN.baddbmm: 1}


def is_dot(func) -> bool:
    """``func`` is a matmul (a ``dot_general`` in the reference)."""
    return func.overloadpacket in _MATMULS


def has_batch(func, args) -> bool:
    """The matmul ``func(*args)`` has a batch dimension: a ``bmm`` or
    ``baddbmm`` whose batch is more than 1."""
    i = _MATMULS[func.overloadpacket]
    return i is not None and args[i].shape[0] != 1


def _saves(policy: str) -> Callable:
    """The selective-checkpoint policy function of "dots" or
    "dots_nobatch": MUST_SAVE for the matmuls it keeps, PREFER_RECOMPUTE
    for every other op."""
    def policy_fn(ctx, func, *args, **kwargs):
        keep = is_dot(func) and (policy == "dots"
                                 or not has_batch(func, args))
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy_fn


def check(policy: str) -> None:
    """Raise unless ``policy`` is one of ``POLICIES`` (the reference's dict
    lookup raises a ``KeyError``)."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {POLICIES}")


def checkpointed(fn: Callable, policy: str) -> Callable:
    """``fn`` under the checkpoint ``policy`` (see the module docstring);
    ``fn`` itself for "none"."""
    check(policy)
    if policy == "none":
        return fn
    kw = {}
    if policy != "full":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _saves(policy))

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run
