"""Train-step builder and fault-tolerant trainer loop (port of
``repro/training/train.py``).

``build_train_step`` assembles the step for any ArchConfig: loss -> grad
(with microbatch accumulation into float32) -> optional int8 error-feedback
gradient compression -> AdamW, in place. ``Trainer`` owns the loop: periodic
and final checkpoints (atomic; the final one is not written again when a
periodic one has just written that step), ``resume="auto"``, straggler watermarks, and
a fault-injection hook that proves crash -> restart -> identical-trajectory
recovery.

The loss runs ``forward`` with ``attn_impl="torch"``, ``ssm_impl="torch"``
and ``moe_impl="einsum"``: the reference trains through the same path
(``M.forward``'s defaults, XLA attention, the XLA chunked scan and the
einsum dispatch), since none of its Pallas kernels has a backward pass, and
neither has any CUDA kernel of the port (their bindings raise on an input
that requires grad).

On the card, with a mesh or without, ``Trainer`` runs its step as the JAX
``Trainer`` runs ``jax.jit(train_step)``: as one program,
``graphs.GraphedTrainStep``, a CUDA graph captured after two eager warm-up
steps and replayed for each later step, bit-equal to the eager step. The
state is updated in place, the error state of the gradient compression
included (on a mesh: each DTensor's local shard), so every leaf keeps its
address from step to step; a restored state captures again. On a mesh the
graph holds the step's collectives too. On the CPU the step runs eagerly.

Sharding: ``build_train_step(cfg, tcfg, rules)`` binds
``distributed.sharding.constrain`` to the rule table and passes it into
``forward``, as the reference does. ``Trainer(mesh=..., rules=...)`` puts
the state on a ``DeviceMesh`` as DTensors placed by ``train_state_axes``
(``distribute_tensor``), each batch by ("batch", "act_seq"), and reads the
metrics with ``full_tensor()`` (a local read of the graphed step's
replicated metrics); the step's arithmetic is the mesh-less step's, run by
DTensor on each rank's shards. Without a mesh the state is
plain tensors and the constraints are the identity.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import resolve_device
from ..configs import ArchConfig
from ..distributed import (CheckpointManager, CompressionConfig,
                           FaultInjector, StragglerDetector,
                           compress_with_feedback, init_error_state)
from ..distributed import sharding as shd
from ..graphs import GraphedTrainStep
from ..models import model as M
from . import loss as L
from . import optim


@dataclass(frozen=True)
class TrainConfig:
    optim: optim.OptimConfig = optim.OptimConfig()
    accum: int = 1                        # microbatch accumulation factor
    compression: Optional[CompressionConfig] = None
    aux_weight: float = 1e-2
    z_loss: float = 1e-4


def make_constrain(rules: Optional[dict]) -> Callable:
    """``sharding.constrain`` bound to ``rules`` (the default table without
    them; on plain tensors it is the identity)."""
    return functools.partial(shd.constrain, rules=rules)


def build_grad_fn(cfg: ArchConfig, tcfg: TrainConfig,
                  rules: Optional[dict] = None) -> Callable:
    """Returns compute_grads(params, batch) -> (grads, metrics): float32
    gradients shaped (and placed) like ``params`` and detached metrics, the
    ``accum`` microbatches' sums divided by ``accum``."""
    constrain = make_constrain(rules)

    def loss_fn(params, batch):
        logits, aux = M.forward(params, cfg, batch["tokens"],
                                attn_impl="torch", ssm_impl="torch",
                                moe_impl="einsum",
                                frontend=batch.get("frontend"),
                                constrain=constrain)
        return L.lm_loss(logits, batch["labels"], aux, tcfg.aux_weight,
                         tcfg.z_loss)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in M.tree_leaves(params)]
        loss, metrics = loss_fn(M.tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return ([g.float() for g in grads],
                {k: v.detach() for k, v in metrics.items()})

    def compute_grads(params, batch):
        a = tcfg.accum
        if a <= 1:
            grads, metrics = grad_fn(params, batch)
            return M.tree_unflatten(params, grads), metrics
        b = batch["tokens"].shape[0]
        assert b % a == 0, (b, a)
        mbs = {k: v.reshape((a, b // a) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        acc = [torch.zeros_like(p, dtype=torch.float32)
               for p in M.tree_leaves(params)]
        met_acc = None
        for i in range(a):
            grads, metrics = grad_fn(params, {k: v[i] for k, v in mbs.items()})
            for x, g in zip(acc, grads):
                x.add_(g)
            del grads
            met_acc = (metrics if met_acc is None else
                       {k: met_acc[k] + metrics[k] for k in met_acc})
        for x in acc:
            x.div_(a)
        return (M.tree_unflatten(params, acc),
                {k: v / a for k, v in met_acc.items()})

    return compute_grads


def build_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                     rules: Optional[dict] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). state is a dict
    {params, opt, err?} of tensors, updated in place; batch {tokens,
    labels} with global batch divisible by tcfg.accum. ``rules`` (a rule
    table) binds the sharding constraints inside ``forward``."""
    compute_grads = build_grad_fn(cfg, tcfg, rules)

    def train_step(state, batch):
        grads, metrics = compute_grads(state["params"], batch)
        if tcfg.compression is not None:
            # the new error goes into state["err"]'s leaves in place
            grads, _ = compress_with_feedback(grads, state["err"],
                                              tcfg.compression)
        _, _, opt_metrics = optim.apply_updates(
            state["params"], grads, state["opt"], tcfg.optim)
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ArchConfig,
                     tcfg: TrainConfig,
                     device: str | torch.device = "cuda") -> dict:
    params = M.init_params(gen, cfg, device)
    state = {"params": params, "opt": optim.init_state(params)}
    if tcfg.compression is not None:
        state["err"] = init_error_state(params)
    return state


def train_state_axes(cfg: ArchConfig, tcfg: TrainConfig) -> dict:
    """The logical axes of every leaf of ``init_train_state``'s tree."""
    pax = M.param_axes(cfg)
    ax = {"params": pax, "opt": optim.state_axes(pax)}
    if tcfg.compression is not None:
        ax["err"] = M.tree_map(lambda a: a, pax)
    return ax


def _metric(v: torch.Tensor) -> float:
    return float(v.full_tensor() if isinstance(v, DTensor) else v)


@dataclass
class Trainer:
    """The fault-tolerant train loop (see the module docstring). On CUDA,
    with a ``mesh`` or without, each step after the first two is a replay
    of one CUDA graph (``graphs.GraphedTrainStep``; on a mesh a step on
    DTensors, its AdamW kernel on each rank's local shards and its
    collectives in the graph); on the CPU the step runs eagerly."""

    cfg: ArchConfig
    tcfg: TrainConfig
    data: Iterator[dict]
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    mesh: Optional[DeviceMesh] = None
    rules: Optional[dict] = None
    seed: int = 0
    fault_injector: Optional[FaultInjector] = None
    straggler: StragglerDetector = field(default_factory=StragglerDetector)
    log_every: int = 10
    log_fn: Callable[[str], None] = print
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        if self.mesh is not None:
            self.device = self.mesh.device_type
        self.device = resolve_device(self.device)
        step = build_train_step(self.cfg, self.tcfg, self.rules)
        # jax.jit's counterpart: a CUDA graph of the step, replayed after its
        # warm-up steps (graphs.GraphedTrainStep)
        self._step_fn = (GraphedTrainStep(step)
                         if self.device.type == "cuda" else step)
        self._placements = (
            shd.tree_placements(self.mesh, train_state_axes(self.cfg,
                                                            self.tcfg),
                                self.rules)
            if self.mesh is not None else None)
        self._mgr = (CheckpointManager(self.ckpt_dir)
                     if self.ckpt_dir else None)
        self.state: Optional[dict] = None
        self.step = 0
        self._saved_step: Optional[int] = None
        self.metrics_history: list[dict] = []

    # ------------------------------------------------------------ lifecycle
    def init_or_resume(self, resume: str = "auto") -> None:
        if (resume in ("auto", "must") and self._mgr is not None
                and self._mgr.latest_step() is not None):
            step, state, _ = self._mgr.restore(device=self.device,
                                               mesh=self.mesh,
                                               placements=self._placements)
            self.state, self.step = state, step
            self.log_fn(f"[trainer] resumed from step {step}")
            return
        if resume == "must":
            raise FileNotFoundError("resume='must' but no checkpoint found")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = init_train_state(gen, self.cfg, self.tcfg, self.device)
        if self.mesh is not None:
            shd.distribute_tree(self.state, self.mesh, self._placements)
        self.step = 0

    def _put(self, batch: dict) -> dict:
        """The batch on the device, and on the mesh by ("batch", "act_seq")
        (a frontend by ("batch", None, None))."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(self.device)
            if self.mesh is not None:
                lg = ("batch", None, None) if k == "frontend" else (
                    "batch", "act_seq")
                t = distribute_tensor(t, self.mesh, shd.placements_for(
                    self.mesh, shd.spec_for(lg, self.rules)))
            out[k] = t
        return out

    def save(self) -> None:
        if self._mgr is not None and self.state is not None:
            self._mgr.save(self.step, self.state)
            self._saved_step = self.step

    # ----------------------------------------------------------------- run
    def run(self, num_steps: int) -> list[dict]:
        assert self.state is not None, "call init_or_resume() first"
        while self.step < num_steps:
            if self.fault_injector is not None:
                self.fault_injector.check(self.step)
            batch = self._put(next(self.data))
            self.straggler.start()
            self.state, metrics = self._step_fn(self.state, batch)
            metrics = {k: _metric(v) for k, v in metrics.items()}
            slow = self.straggler.stop(self.step)
            if slow is not None:
                self.log_fn(f"[trainer] straggler step {self.step}: "
                            f"{slow:.1f}x median")
            self.step += 1
            metrics["step"] = self.step
            self.metrics_history.append(metrics)
            if self.step % self.log_every == 0:
                self.log_fn(
                    f"[trainer] step {self.step} "
                    f"loss={metrics.get('loss', float('nan')):.4f} "
                    f"acc={metrics.get('accuracy', 0.0):.3f} "
                    f"gnorm={metrics.get('grad_norm', 0.0):.2f}")
            if (self._mgr is not None and self.ckpt_every
                    and self.step % self.ckpt_every == 0):
                self.save()
        if self._saved_step != self.step:    # the final checkpoint, once
            self.save()
        return self.metrics_history
