"""Elastic re-mesh, straggler detection and fault injection (port of
``repro/distributed/elastic.py``).

Elastic re-mesh: when nodes join or leave, the runner rebuilds the mesh
from the surviving ranks (``remesh``: the largest (data, model)
factorization that keeps the model axis intact), then restores the latest
checkpoint onto the new mesh: checkpoint arrays carry global shapes, so
restore is the reshard (``CheckpointManager.restore(mesh=...,
placements=...)``).

Straggler mitigation: per-step watermark timing. The trainer records step
wall times in a rolling window; a step slower than ``threshold`` x the
rolling median flags a straggler event. The detector provides the signal;
the response (swap the slow host out and restart elastically from the last
checkpoint) is the re-mesh and restore path above.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def best_mesh_shape(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid for a possibly-degraded device count.

    Keeps the model axis at the requested size (weights are sharded over it;
    changing it mid-run would re-tile every matmul) and gives the rest to
    data parallelism. Falls back to shrinking model parallelism only when
    the device count no longer divides.
    """
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    return max(n_devices // mp, 1), mp


def remesh(world_size: Optional[int] = None, model_parallel: int = 1,
           axis_names: tuple[str, str] = ("data", "model"),
           device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over the first ranks of the
    initialised process group, shaped by ``best_mesh_shape`` for
    ``world_size`` ranks (the group's size by default), on ``device_type``
    (CUDA when the group's backend is NCCL, else the CPU). Every rank of
    the group calls it. Raises if no process group is initialised: it never
    starts one itself."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("remesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size() if world_size is None else world_size
    dp, mp = best_mesh_shape(n, model_parallel)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(dp * mp).reshape(dp, mp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axis_names)


@dataclass
class StragglerDetector:
    """Rolling-median step-time watermark."""

    window: int = 32
    threshold: float = 2.0
    min_samples: int = 8
    times: deque = field(default_factory=lambda: deque(maxlen=64))
    events: list = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> Optional[float]:
        """Record a step; returns the slowdown factor if it straggled."""
        assert self._t0 is not None
        dt = time.monotonic() - self._t0
        self._t0 = None
        if len(self.times) >= self.min_samples:
            med = sorted(self.times)[len(self.times) // 2]
            if med > 0 and dt > self.threshold * med:
                factor = dt / med
                self.events.append((step, factor))
                self.times.append(dt)
                return factor
        self.times.append(dt)
        return None


@dataclass
class FaultInjector:
    """Deterministic fault-injection hook: raises a simulated preemption at
    configured steps, so that the trainer's recovery path (checkpoint ->
    restart -> resume) can be exercised end to end."""

    fail_at_steps: tuple[int, ...] = ()

    def check(self, step: int) -> None:
        if step in self.fail_at_steps:
            raise SimulatedPreemption(step)


class SimulatedPreemption(RuntimeError):
    def __init__(self, step: int):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step
