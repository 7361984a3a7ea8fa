"""Run one cell of the benchmark on the card and print its result line.

    python3 -m rtmmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without CUDA, or with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
by the end of the window, it prints no result and exits with 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import ROOT  # noqa: E402

#: caches of whatever compiles, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/rtmmbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/rtmmbench/triton"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtmmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)

    import torch

    from . import harness
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"rtmmbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0), T0,
                               bench=bench)
    except harness.ForbiddenModules as e:
        print(f"rtmmbench: modules loaded by the end of the window: {e}",
              file=sys.stderr)
        return 2
    left = harness.forbidden_modules()
    if left:
        print(f"rtmmbench: modules loaded by the end of the run: {left}",
              file=sys.stderr)
        return 2
    for name, value, limit in out.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(out.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
