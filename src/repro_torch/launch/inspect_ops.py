"""Op profiler for the dry-run: what dominates the bytes touched? (port of
``repro/launch/inspect_hlo.py``).

The reference groups the optimized HLO's buffer traffic by op kind and by
shape. Eager PyTorch has no optimized program, so this takes the dry-run's
tally of one cell (``dryrun.tally_cell``: every aten op's input and output
bytes, counted on meta tensors) and groups it by aten op and by output
shape, so a performance iteration can name the tensor it is about to
shrink. The bytes are the unfused eager traffic, split evenly over the
mesh's devices as the dry-run splits them.

    PYTHONPATH=src python -m repro_torch.launch.inspect_ops \\
        --arch qwen1.5-4b --shape train_4k --top 25
"""
from __future__ import annotations

import argparse
import math

from ..configs import ARCH_IDS, SHAPES
from ..distributed.sharding import mesh_axis_sizes
from .dryrun import Tally, count_cell, tally_cell
from .mesh import make_production_mesh


def analyze(tally: Tally, n_dev: int = 1, top: int = 20) -> None:
    """Print the ops and the shapes that touch the most bytes (per device,
    an even split over ``n_dev``)."""
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
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"))
    tally = tally_cell(args.arch, args.shape)
    res = count_cell(args.arch, args.shape, mesh, tally=tally)
    print("terms:", {k: round(v, 4) for k, v in res["terms_s"].items()})
    analyze(tally, math.prod(mesh_axis_sizes(mesh).values()), top=args.top)


if __name__ == "__main__":
    main()
