"""Training entry point (port of ``repro/launch/train.py``).

On the card:   python -m repro_torch.launch.train --arch gemma2-2b --steps 100 \
                   --ckpt-dir ckpts/run1
On the CPU (reduced config):
               PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
                   --smoke --steps 100 --device cpu

On several ranks (one process a card, ``torchrun --nproc-per-node N``):
               torchrun --nproc-per-node 4 -m repro_torch.launch.train \
                   --arch gemma2-2b --model-parallel 2

Fault tolerance: --resume auto restores the newest checkpoint (atomic, and
onto the current mesh: the elastic-restart path); --fail-at N simulates a
preemption at step N so the restart path can be demonstrated end to end.

With more than one rank (``WORLD_SIZE`` above 1, as torchrun sets it) the
process group is initialised from the environment (NCCL on the card, gloo
on the CPU) and the mesh is ``remesh(model_parallel=...)``, with the rule
table ``rules_for_mesh``; with one rank there is no mesh and
--model-parallel has no effect, as in the reference's launcher.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, smoke_config
from ..data import SyntheticLMData
from ..distributed import CompressionConfig, FaultInjector, remesh
from ..training import OptimConfig, TrainConfig, Trainer
from .mesh import rules_for_mesh


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config, float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto",
                    choices=["auto", "never", "must"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a preemption at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512),
                                  dtype="float32")
    mesh = rules = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if args.device.startswith("cuda")
                                else "gloo")
        mesh = remesh(model_parallel=args.model_parallel)
        rules = rules_for_mesh(mesh)

    tcfg = TrainConfig(
        optim=OptimConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                          total_steps=args.steps),
        accum=args.accum,
        compression=CompressionConfig() if args.compress_grads else None,
    )
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)
    trainer = Trainer(
        cfg=cfg, tcfg=tcfg, data=iter(data), ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, mesh=mesh, rules=rules, seed=args.seed,
        fault_injector=(FaultInjector((args.fail_at,))
                        if args.fail_at is not None else None),
        device=args.device,
    )
    trainer.init_or_resume(resume=args.resume)
    history = trainer.run(args.steps)
    if mesh is not None:
        dist.destroy_process_group()
    if history:
        print(f"[train] done: step={history[-1]['step']} "
              f"loss={history[-1]['loss']:.4f} "
              f"acc={history[-1]['accuracy']:.3f}")


if __name__ == "__main__":
    main()
