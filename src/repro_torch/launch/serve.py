"""Serving entry point: a multi-model RTMM workload on the serving engine
(port of ``repro/launch/serve.py``).

Registers a set of reduced-config models as concurrent FPS streams (with a
cascade dependency and Supernet variants), builds heterogeneous virtual
accelerator slices, and runs the DREAM-dispatch engine in real time on the
GPU, with the attention and SSD layers in the hand-written CUDA kernels and
each model's forward replayed from CUDA graphs.

    PYTHONPATH=src python -m repro_torch.launch.serve --duration 10
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..configs import smoke_config
from ..convert import to_compute_dtype
from ..graphs import GraphedForward
from ..kernels import build
from ..models import model as M
from ..serving import (ModelHandle, RequestQueue, ServingEngine,
                       VirtualAccelerator)


def build_handle(arch: str, name: str, *, layers: int | None = None,
                 d_model: int | None = None, seed: int = 0,
                 device: str | torch.device = "cuda") -> ModelHandle:
    """A reduced-config model of ``arch`` with random weights drawn from
    ``seed`` on ``device`` (CUDA unless the caller asks for the CPU). On
    CUDA the kernels are built here, in set-up, before any timed call, and
    the logits function replays CUDA graphs (``graphs.GraphedForward``, the
    counterpart of the reference's ``jax.jit``): the engine's untimed
    calibration call captures each at its stream and shape. On the CPU it
    runs eagerly."""
    dev = resolve_device(device)
    cfg = smoke_config(arch)
    upd = {"vocab_size": 128, "scan_layers": False}
    if layers:
        upd["num_layers"] = layers
    if d_model:
        upd["d_model"] = d_model
        upd["d_ff"] = 2 * d_model
    cfg = dataclasses.replace(cfg, **upd)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = to_compute_dtype(M.init_params(gen, cfg, dev),
                              M.compute_dtype(cfg))
    if dev.type == "cuda":
        build.load()

    @torch.inference_mode()
    def fn(p, tokens):
        logits, _ = M.forward(p, cfg, tokens)
        return logits

    return ModelHandle(name=name, cfg=cfg, params=params,
                       fn=GraphedForward(fn) if dev.type == "cuda" else fn)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--no-drop", action="store_true")
    ap.add_argument("--no-supernet", action="store_true")
    ap.add_argument("--no-adapt", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # heterogeneous 3-slice system (a big fast slice + two small efficient)
    accs = [
        VirtualAccelerator("big0", speed=1.0, power=1.0),
        VirtualAccelerator("small0", speed=0.45, power=0.4),
        VirtualAccelerator("small1", speed=0.45, power=0.4),
    ]
    engine = ServingEngine(
        accs, adaptivity=not args.no_adapt, frame_drop=not args.no_drop,
        supernet_switch=not args.no_supernet, seed=args.seed)

    # model set: detector -> verifier cascade + context supernet + kws
    dev = args.device
    det = build_handle("gemma-2b", "detector", layers=2, device=dev)
    verif = build_handle("qwen1.5-4b", "verifier", layers=2, device=dev)
    ctx = build_handle("gemma2-2b", "context", layers=4, device=dev)
    ctx_v1 = build_handle("gemma2-2b", "context@v1", layers=2, device=dev)
    ctx.supernet = ("context@v1",)
    kws = build_handle("mamba2-130m", "kws", layers=2, device=dev)

    # calibrate every model with its stream shape
    calib32 = np.zeros((1, 32), np.int32)
    calib16 = np.zeros((1, 16), np.int32)
    for h in (det, verif, ctx, ctx_v1):
        engine.register(h, calib32)
    engine.register(kws, calib16)

    q = RequestQueue(clock=lambda: 0.0)
    q.add_stream("detector", fps=8, batch=1, seq=32, vocab=128,
                 deadline_frac=1.0)
    q.add_stream("verifier", fps=8, batch=1, seq=32, vocab=128,
                 depends_on="detector", trigger_prob=0.5)
    q.add_stream("context", fps=4, batch=1, seq=32, vocab=128)
    q.add_stream("kws", fps=12, batch=1, seq=16, vocab=128)

    report = engine.run(q, duration_s=args.duration)
    print("[serve]", report.summary())
    for name, st in sorted(report.per_model.items()):
        print(f"[serve]   {name:>12s} frames={st['frames']:4d} "
              f"violated={st['violated']:4d} energy={st['energy']:.3f}")
    print(f"[serve] final (alpha, beta) = "
          f"({report.alpha:.2f}, {report.beta:.2f})")


if __name__ == "__main__":
    main()
