#!/usr/bin/env python3
"""Times the port's bfloat16 grouped-matmul, SSD and decode-attention
kernels at ``chip_smoke.py``'s full-width cases.

    python3 scripts/time_kernels.py [--root CHECKOUT]

The cases (``GMM_FULL_WIDTH``, ``SSD_FULL_WIDTH``, ``DECODE_KERNEL_CASES``
and ``DECODE_MOE_CASES``), the inputs and the
timing (CUDA events, a cold L2 before each run, the host's launch path off
the clock, median of ``KERNEL_REPS``) are this checkout's
``chip_smoke.py``'s, so the numbers read like its phases 3, 7 and 8. The inputs
come from one seeded generator, so every checkout is timed on the same
data. ``repro_torch`` is imported from ``CHECKOUT/src`` (default: this
checkout): two commits are compared on one card in one run by unpacking the
other into a git-ignored directory and running both in turns (A, B, B, A).
Prints the card's name and power limit, then one line per case. Needs a
CUDA card.
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
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    cs.log(f"[time_kernels] {cs.gpu_name_and_power()}; repro_torch from "
           f"{Path(ops.__file__).resolve().parents[1]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = cs.cold_l2(torch)
    for label, t, d, f, e, spec, _ in cs.GMM_FULL_WIDTH:
        _, sizes, x, w = cs.gmm_inputs(torch, gen, t, d, f, e, spec,
                                       torch.bfloat16)
        ms = cs.time_ms(lambda: ops.gmm(x, w, sizes), reps=cs.KERNEL_REPS,
                        flush=flush)
        cs.log(f"[time_kernels] gmm {label} T={t} D={d} F={f} E={e}: ms={ms}")
        del x, w
        torch.cuda.empty_cache()
    for label, b, s, h, p, n, ch in cs.SSD_FULL_WIDTH:
        x, dt, A, B, C, D = cs.ssd_inputs(torch, gen, b, s, h, p, n,
                                          torch.bfloat16)
        ms = cs.time_ms(lambda: ops.ssd(x, dt, A, B, C, D, chunk=ch),
                        reps=cs.KERNEL_REPS, flush=flush)
        cs.log(f"[time_kernels] ssd {label} B={b} S={s} H={h} P={p} N={n} "
               f"chunk={ch}: ms={ms}")
    for label, s, n, k, h, win, cap, pos_list in (cs.DECODE_KERNEL_CASES +
                                                  cs.DECODE_MOE_CASES):
        q, kc, vc = cs.decode_inputs(torch, gen, len(pos_list), s, n, k, h,
                                     torch.bfloat16)
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        ms = cs.time_ms(lambda: ops.decode_attention(
            q, kc, vc, pos, window=win, softcap=cap), reps=cs.KERNEL_REPS,
            flush=flush)
        cs.log(f"[time_kernels] decode {label} B={len(pos_list)} S={s} N={n} "
               f"K={k} H={h} window={win} softcap={cap} pos={pos_list}: "
               f"ms={ms}")
        del q, kc, vc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
