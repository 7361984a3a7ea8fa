"""Op profiler for the dry-run: what dominates the bytes touched? (port of
``repro/launch/inspect_hlo.py``).

The reference groups the optimized HLO's buffer traffic by op kind and by
shape. Eager PyTorch has no optimized program, so this takes a dry-run
tally (every op's input and output bytes, counted on meta tensors) and
groups it by op and by output shape, so a performance iteration can name
the tensor it is about to shrink. The CLI tallies rank 0 of the production
mesh (``dryrun.mesh_tally``: its own ops, on its shards); ``analyze`` also
takes the global tally of ``dryrun.tally_cell``, split evenly over
``n_dev``. The bytes are the unfused eager traffic. A train cell runs under
the rematerialisation policy ``--remat`` ("dots" by default, as the
reference's ``inspect_hlo.py``), its recompute counted with the rest.

    PYTHONPATH=src python -m repro_torch.launch.inspect_ops \\
        --arch qwen1.5-4b --shape train_4k --remat dots_nobatch --top 25
"""
from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, SHAPES, get_config
from ..models.remat import POLICIES
from .dryrun import Tally, cell_config, fake_mesh, mesh_tally
from .mesh import make_production_mesh, rules_for


def analyze(tally: Tally, n_dev: int = 1, top: int = 20) -> None:
    """Print the ops and the shapes that touch the most bytes (per device:
    ``tally`` over ``n_dev``, 1 for a rank's own tally)."""
    print("top ops by bytes touched (per device, summed over calls):")
    for op, b in sorted(tally.by_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {op:>28s} {b / n_dev / 1e9:10.2f} GB  "
              f"x{tally.count_op[op]}")
    print("top individual shapes (output shape, op):")
    big = [(sh, b) for sh, b in tally.by_shape.items() if b > (1 << 20)]
    for sh, b in sorted(big, key=lambda kv: -kv[1])[:top]:
        print(f"  {b / n_dev / 1e9:10.2f} GB  {sh[:80]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod"])
    ap.add_argument("--remat", default="dots", choices=list(POLICIES))
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    cell = SHAPES[args.shape]
    cfg = cell_config(get_config(args.arch), cell, args.remat)
    mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"))
    with fake_mesh(mesh) as dm:
        local = mesh_tally(cfg, cell, dm, rules_for(cfg, dm, cell))
    print(f"rank 0 of {args.mesh}, remat {cfg.remat}: "
          f"{local.flops / 1e12:.3f} TFLOP, {local.bytes / 1e9:.2f} GB "
          f"touched, peak {local.peak_bytes / 1e9:.2f} GB allocated, "
          f"collectives (GB) "
          f"{ {k: v / 1e9 for k, v in local.collective_bytes().items()} }")
    analyze(local, top=args.top)


if __name__ == "__main__":
    main()
