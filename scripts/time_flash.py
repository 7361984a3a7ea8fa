#!/usr/bin/env python3
"""Times the port's bfloat16 flash-attention kernel at ``chip_smoke.py``'s
full-width flash cases.

    python3 scripts/time_flash.py [--root CHECKOUT]

The cases, the inputs and the timing (CUDA events, a cold L2 before each
run, median of ``FLASH_REPS``) are this checkout's ``chip_smoke.py``'s, so
the numbers read like its phase 3. ``repro_torch`` is imported from
``CHECKOUT/src`` (default: this checkout): two commits are compared on one
card in one run by unpacking the other into a git-ignored directory and
running both in turns (A, B, B, A). Prints the card's name and power limit,
then one line per case. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    # ahead of the src/ that chip_smoke put on the path
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    cs.log(f"[time_flash] {cs.gpu_name_and_power()}; repro_torch from "
           f"{Path(ops.__file__).resolve().parents[1]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = cs.cold_l2(torch)
    for label, b, s, n, k, h, win, cap in cs.FLASH_FULL_WIDTH:
        q, kk, v = cs.flash_inputs(torch, gen, b, s, n, k, h, torch.bfloat16)
        ms = cs.time_ms(lambda: ops.flash_attention(q, kk, v, window=win,
                                                    softcap=cap),
                        reps=cs.FLASH_REPS, flush=flush)
        cs.log(f"[time_flash] {label} B={b} S={s} N={n} K={k} H={h} "
               f"window={win} softcap={cap}: ms={ms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
