"""CUDA graphs for the served forward, ``decode_step`` and the train step:
the port's counterpart of ``jax.jit``.

The JAX package compiles the step it serves and the step it trains:
``repro/launch/serve.py`` wraps each model's logits function in
``jax.jit``, the engine runs each frame as one compiled program at the shape
it was calibrated on, and ``repro/training/train.py``'s ``Trainer`` jits
``build_train_step``. Run eagerly, every kernel of a step is a launch
dispatched from Python, and the host, not the card, bounds the step. Here
the same function is captured once per key into a ``torch.cuda.CUDAGraph``
and replayed.

* ``GraphedForward(fn)``: ``fn(params, tokens) -> logits``, one graph per
  calling stream, tokens shape and dtype, and the ``data_ptr``s of the
  params leaves. As under ``jax.jit``, a new shape or new params capture again;
  nothing is captured silently later than the first call with a key, so an
  engine whose untimed calibration call made the capture times replays.
* ``GraphedDecode``: ``models.model.decode_step`` over one cache, one graph
  per calling stream and batch. The step takes ``pos`` on the device, writes
  the cache in place and sizes every kernel from the shapes alone, so one
  graph serves every position.
* ``GraphedTrainStep(fn)``: ``train_step(state, batch) -> (state,
  metrics)`` (``training.build_train_step``), one graph per calling stream,
  batch keys with their shapes, dtypes and placements, the mesh, and the
  ``data_ptr``s of every state leaf (params, m, v, step, err; of a DTensor
  its local shard): the step updates them in place, so a restored or
  reallocated state captures again. On a mesh the step's collectives are
  captured with it, and its metrics leave the graph replicated, so reading
  them issues none. Its warm-up calls are the run's own steps (below).

Common to all three:

* a graph is captured on a stream of its own, after ``WARMUP_CALLS`` eager
  calls there, so that what the first call makes lazily (the kernels
  library, each kernel's shared-memory attribute, cuBLAS's workspace for the
  stream, autograd's device thread) exists before the capture; it is
  replayed on the caller's current stream. The forward warms up on its
  inputs and the decode step on a zeroed scratch cache; the train step
  cannot (a scratch copy of gemma2-2b's state is 31 GB), so its first
  ``WARMUP_CALLS`` calls with a key are real steps, run eagerly on the
  graph's stream, and the next call captures (which executes nothing) and
  replays: the run's trajectory is an eager run's. Each graph has its own
  memory pool and static inputs, so graphs replayed at once on two streams
  share no buffer (decode attention's merge counters included: a captured
  call takes them from its graph's pool);
* a call copies its inputs into the graph's static inputs, replays, and
  returns a fresh clone of the static output (each leaf of the train
  step's metrics), as ``jax.jit`` returns new arrays: an engine keeps every
  frame's result, which the next replay would otherwise overwrite;
* the capture's kernel calls are recorded, not counted
  (``kernels.build.recording``); each replay adds them to the bindings'
  launch counters (``kernels.build.add_counts``);
* on the CPU, which only a caller that asks for it gets, the eager function
  runs unchanged. On CUDA a capture or replay that fails raises: nothing
  falls back to the eager function.

Captures are serialised by one lock, and ``torch.cuda.graph`` synchronises
the device before each: capture at set-up (``ServingEngine.register``'s
untimed call), not while other threads serve.
"""
from __future__ import annotations

import gc
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from .configs import ArchConfig
from .kernels import build
from .models import model as M
from .placement import replicated

Tensor = torch.Tensor

#: eager calls on the capture stream before a capture
WARMUP_CALLS = 2

_capture_lock = threading.Lock()


def _local(t: Tensor) -> Tensor:
    """A DTensor's local shard (a wrapper has no storage of its own); a
    plain tensor itself. The attribute, not ``to_local()``: a key is built
    at every call, and ``to_local`` is an autograd function."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _ptrs(tree) -> tuple[int, ...]:
    return tuple(_local(t).data_ptr() for t in M.tree_leaves(tree))


def _layout(t: Tensor) -> tuple:
    """What a graph bakes in of a batch tensor besides its address: shape,
    dtype, and on a mesh its mesh and placements."""
    if isinstance(t, DTensor):
        return (tuple(t.shape), t.dtype, t.device_mesh, tuple(t.placements))
    return (tuple(t.shape), t.dtype)


def _like(local: Tensor, t: Tensor) -> Tensor:
    """``local`` as the shard of a DTensor placed like ``t`` (no
    communication); ``local`` itself beside a plain ``t``."""
    if not isinstance(t, DTensor):
        return local
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


@dataclass
class Graph:
    """One captured call: its graph, static inputs and output (a tensor or
    a dict of them), and the kernel launches its capture recorded
    ({binding: (launches, {kernel: launches})})."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple[Tensor, ...]
    output: Any
    launches: dict

    def replay(self, *args: Tensor) -> Any:
        """Copy ``args`` into the static inputs and replay on the current
        stream; a fresh copy of the output."""
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        build.add_counts(self.launches)
        return M.tree_map(torch.clone, self.output)


def capture(run: Callable[..., Any], inputs: tuple[Tensor, ...],
            warm: Optional[Callable[..., Any]] = None, *,
            warmup: int = WARMUP_CALLS,
            side: Optional[torch.cuda.Stream] = None,
            mode: str = "thread_local") -> Graph:
    """Capture ``run(*static)`` on static copies of ``inputs``, made on the
    caller's current stream, after ``warmup`` calls of ``warm`` (by
    default ``run``) on them on the capture's stream ``side`` (by default a
    new one), in ``torch.cuda.graph``'s ``capture_error_mode`` ``mode``.
    Raises if the capture fails; the caller's current stream is current
    again afterwards either way."""
    device = inputs[0].device
    # ``torch.cuda.graph`` empties the allocator's cache before a capture but
    # collects no garbage: memory a dead reference cycle still holds would
    # stay out of reach of the graph's pool
    gc.collect()
    caller = torch.cuda.current_stream(device)
    static = tuple(t.clone() for t in inputs)
    side = side if side is not None else torch.cuda.Stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        for _ in range(warmup):
            (warm or run)(*static)
    g = torch.cuda.CUDAGraph()
    try:
        with build.recording() as launches:
            with torch.cuda.graph(g, stream=side, capture_error_mode=mode):
                out = run(*static)
    finally:
        # a capture that fails inside ``torch.cuda.graph`` leaves its
        # stream current
        torch.cuda.set_stream(caller)
    caller.wait_stream(side)
    return Graph(g, static, out, dict(launches))


class GraphedForward:
    """``fn(params, tokens) -> logits`` replayed from CUDA graphs on CUDA
    tokens, the counterpart of ``jax.jit(fn)`` (see the module docstring);
    ``eager`` is ``fn`` itself, and ``graphs`` holds one ``Graph`` per
    key."""

    def __init__(self, fn: Callable[[dict, Tensor], Tensor]):
        self.eager = fn
        self.graphs: dict[tuple, Graph] = {}

    def __call__(self, params: dict, tokens: Tensor) -> Tensor:
        if tokens.device.type != "cuda":
            return self.eager(params, tokens)
        stream = torch.cuda.current_stream(tokens.device)
        key = (tokens.device.index, stream.cuda_stream, tuple(tokens.shape),
               tokens.dtype, _ptrs(params))
        with torch.inference_mode():
            g = self.graphs.get(key)
            if g is None:
                with _capture_lock:
                    g = self.graphs.get(key)
                    if g is None:
                        g = capture(lambda t: self.eager(params, t), (tokens,))
                        self.graphs[key] = g
            return g.replay(tokens)


class GraphedDecode:
    """``decode_step(params, cfg, tokens, cache, pos)`` over one cache,
    replayed from CUDA graphs when the tokens lie on CUDA.

    A call takes ``tokens`` [B, 1] and ``pos`` [B] (int) and returns
    ``(logits [B, 1, V], cache)`` as ``decode_step`` does: the logits a
    fresh tensor, the cache advanced in place. The graph of a (stream, batch)
    pair is captured at its first call, after warm-up steps on a zeroed
    scratch cache of the same shapes (a warm-up on the real cache would
    advance an SSM state twice).

    The graphs bake in the addresses of ``params`` and of every cache leaf:
    neither may be reallocated after the first call (assign into the leaves
    in place, ``copy_``), and a call raises if a leaf's ``data_ptr`` moved.
    """

    def __init__(self, params: dict, cfg: ArchConfig, cache: dict):
        self.params, self.cfg, self.cache = params, cfg, cache
        self._ptrs = _ptrs(params) + _ptrs(cache)
        self.graphs: dict[tuple, Graph] = {}

    def _step(self, tokens: Tensor, pos: Tensor, cache: dict) -> Tensor:
        return M.decode_step(self.params, self.cfg, tokens, cache, pos)[0]

    def __call__(self, tokens: Tensor, pos: Tensor) -> tuple[Tensor, dict]:
        if _ptrs(self.params) + _ptrs(self.cache) != self._ptrs:
            raise RuntimeError("GraphedDecode: a params or cache leaf was "
                               "reallocated; its graphs hold the old "
                               "addresses (write the cache in place)")
        with torch.inference_mode():
            if tokens.device.type != "cuda":
                return self._step(tokens, pos, self.cache), self.cache
            stream = torch.cuda.current_stream(tokens.device)
            key = (tokens.device.index, stream.cuda_stream,
                   tuple(tokens.shape), tokens.dtype, tuple(pos.shape))
            g = self.graphs.get(key)
            if g is None:
                with _capture_lock:
                    scratch = M.tree_map(torch.zeros_like, self.cache)
                    g = capture(
                        lambda t, p: self._step(t, p, self.cache),
                        (tokens, pos.to(tokens.device, torch.int32)),
                        warm=lambda t, p: self._step(t, p, scratch))
                    del scratch
                    self.graphs[key] = g
            return g.replay(tokens, pos), self.cache


class GraphedTrainStep:
    """``train_step(state, batch) -> (state, metrics)`` replayed from CUDA
    graphs on a CUDA state, the counterpart of ``jax.jit(train_step)`` in
    the JAX package's ``Trainer`` (see the module docstring); ``eager`` is
    ``train_step`` itself, ``graphs`` holds one ``Graph`` per key.

    ``train_step`` must update every state leaf in place (it does: params,
    m, v and the step by the optimizer, the error state by
    ``compress_with_feedback``): the graph bakes in their addresses. The
    first ``WARMUP_CALLS`` calls with a key run the step eagerly on the
    key's own stream, the next one captures it there and replays it, and
    every later call copies the batch into the graph's static batch and
    replays on the caller's stream. A call returns the state (updated in
    place) and the metrics, fresh tensors.

    The capture runs in ``capture_error_mode="global"``, the mode of
    ``torch.cuda.make_graphed_callables``, which also captures a backward:
    ``torch.autograd.grad`` runs the backward on autograd's device thread,
    and ``"thread_local"`` would forbid unsafe CUDA calls (a host sync) only
    on the capturing thread, leaving that one unchecked.

    On a mesh (a state of DTensors) the graph is the same step: its static
    batch is the local shards of the batch DTensors, rebuilt inside the
    capture with ``DTensor.from_local`` at their placements; the state's
    local shards are updated in place as without a mesh; the collectives the
    step issues (NCCL's, on a card) are captured in the graph, the process
    group's communicator having been made by a warm-up step; and each
    metric is redistributed to ``Replicate()`` inside the capture, so that
    reading it after a replay is a local read. A DTensor state on the CPU
    runs eagerly, as a plain one does.
    """

    def __init__(self, fn: Callable[[dict, dict], tuple[dict, dict]]):
        self.eager = fn
        self.graphs: dict[tuple, Graph] = {}
        #: per key not captured yet: (eager calls made, the key's stream)
        self._warm: dict[tuple, tuple[int, torch.cuda.Stream]] = {}

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        leaves = M.tree_leaves(state)
        device = _local(leaves[0]).device
        if device.type != "cuda":
            return self.eager(state, batch)
        names = sorted(batch)
        given = [batch[k] for k in names]
        inputs = tuple(_local(t) for t in given)
        stream = torch.cuda.current_stream(device)
        mesh = getattr(leaves[0], "device_mesh", None)
        key = (device.index, stream.cuda_stream, mesh,
               tuple((k, _layout(t)) for k, t in zip(names, given)),
               _ptrs(state))
        g = self.graphs.get(key)
        if g is None:
            with _capture_lock:
                g = self.graphs.get(key)
                if g is None:
                    calls, side = self._warm.get(key, (0, None))
                    side = side if side is not None else torch.cuda.Stream(
                        device)
                    if calls < WARMUP_CALLS:
                        self._warm[key] = (calls + 1, side)
                        return state, self._eager_on(side, state, batch)

                    def run(*static):
                        b = {k: _like(x, t)
                             for k, x, t in zip(names, static, given)}
                        metrics = self.eager(state, b)[1]
                        return {k: replicated(v) for k, v in metrics.items()}
                    g = capture(run, inputs, warmup=0, side=side,
                                mode="global")
                    del self._warm[key]
                    self.graphs[key] = g
        return state, g.replay(*inputs)

    def _eager_on(self, side: torch.cuda.Stream, state: dict,
                  batch: dict) -> dict:
        """One eager step on ``side``, ordered after the caller's stream
        and before its later work; the metrics."""
        caller = torch.cuda.current_stream(side.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            _, metrics = self.eager(state, batch)
        caller.wait_stream(side)
        for t in metrics.values():
            _local(t).record_stream(caller)     # read on the caller's stream
        return metrics
