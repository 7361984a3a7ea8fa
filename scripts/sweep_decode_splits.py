#!/usr/bin/env python3
"""Times the bf16 decode-attention kernel at ``chip_smoke.py``'s decode cases
over a range of split counts, beside the count ``num_splits`` picks.

    python3 scripts/sweep_decode_splits.py

For each case of ``DECODE_KERNEL_CASES`` and ``DECODE_MOE_CASES`` (bf16,
inputs from one seeded generator), the kernel is timed as ``chip_smoke.py``
times it (CUDA events, a cold L2 before each run, the host's launch path off
the clock, median of ``KERNEL_REPS``) with ``num_splits`` replaced by each
count of ``SPLITS`` that the live range and the merge's shared memory
(``MERGE_BYTES``) allow, then at ``pos`` 0 with the
rule's count (a call's fixed cost: one tile, and every split merged). Prints
the card's name and power limit, then one line per case, in us. It is the
evidence behind ``num_splits``'s rule; nothing is checked here. Needs a CUDA
card.
"""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

SPLITS = (2, 4, 6, 8, 12, 16, 24, 33)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_decode_splits: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    cs.log(f"[sweep] {cs.gpu_name_and_power()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = cs.cold_l2(torch)
    rule = dec.num_splits
    for label, s, n, k, h, win, cap, pos_list in (cs.DECODE_KERNEL_CASES +
                                                  cs.DECODE_MOE_CASES):
        b = len(pos_list)
        q, kc, vc = cs.decode_inputs(torch, gen, b, s, n, k, h, torch.bfloat16)
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        run = lambda p=pos: ops.decode_attention(q, kc, vc, p, window=win,
                                                 softcap=cap)
        tiles = -(-(min(s, win) if win else s) // dec.TILE)
        picked = rule(b, k, s, win, n // k, h)
        times = []
        try:
            for splits in sorted(set(SPLITS) | {picked}):
                merge = splits * (128 + 4 * (n // k) * h)
                if splits > tiles or merge > dec.MERGE_BYTES:
                    continue  # more than the kernel takes
                dec.num_splits = lambda *a, _n=splits, **kw: _n
                us = cs.time_ms(run, reps=cs.KERNEL_REPS, flush=flush) * 1e3
                times.append(f"{splits}:{us:.2f}")
        finally:
            dec.num_splits = rule
        zero = torch.zeros_like(pos)
        us0 = cs.time_ms(lambda: run(zero), reps=cs.KERNEL_REPS,
                         flush=flush) * 1e3
        cs.log(f"[sweep] decode {label} B={b} S={s} N={n} K={k} H={h}: rule "
               f"{picked} splits; us by splits {' '.join(times)}; at pos 0 "
               f"{us0:.2f}")
        del q, kc, vc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
