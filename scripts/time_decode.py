#!/usr/bin/env python3
"""Times the port's decode path end to end at ``chip_smoke.py``'s
full-width decode and MoE runs, and the host's enqueue time of one
grouped-matmul call at its decode shapes and of one decode-attention call
at gemma2-2b's.

    python3 scripts/time_decode.py [--root CHECKOUT]

For each run of ``DECODE_FULL_WIDTH`` and ``MOE_FULL_WIDTH`` (the same
architectures, depths, prompts, cache rows and seeds as ``chip_smoke.py``'s
phases 7 and 8; bf16, random weights from the seed): ``prefill`` of the
prompt, one untimed step, then ``STEPS`` greedy ``decode_step``s, each timed
on the host's clock between two synchronisations, as ``chip_smoke.py`` times
them; prints the median, min and max ms per decoded token. Each run has two
arms on the same prompt: eager, and through ``repro_torch.graphs``'s
``GraphedDecode`` (the untimed step captures the graph), where the checkout
has that module. Then, at each
decode case of ``GMM_FULL_WIDTH``, and at gemma2-2b's global layer of
``DECODE_KERNEL_CASES`` (bf16), the median over ``ENQUEUE_REPS`` calls of the
host time that ``ops.gmm`` or ``ops.decode_attention`` takes to return, each
call started on an idle card: what a call adds to a host-bound step. No output is checked here;
``chip_smoke.py`` does that.

``repro_torch`` is imported from ``CHECKOUT/src`` (default: this checkout):
two commits are compared on one card in one run by unpacking the other into
a git-ignored directory and running both in turns (A, B, B, A). Prints the
card's name and power limit, then one line per run. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

STEPS = 31           # timed decode steps, after one untimed (the caches
                     # hold 32 rows past the prompt)
ENQUEUE_REPS = 200   # timed gmm or decode-attention calls a case


def step_times(torch, M, params, cfg, tokens, max_seq: int,
               graphs=None) -> list[float]:
    """ms of each of ``STEPS`` greedy decode steps after a prefill of
    ``tokens``, eager or, given the ``graphs`` module, replayed from a
    ``GraphedDecode``."""
    prompt = tokens.shape[1]
    times = []
    with torch.inference_mode():
        cache = M.init_cache(cfg, 1, max_seq, torch.bfloat16, "cuda")
        logits, cache = M.prefill(params, cfg, tokens, cache)
        step = (graphs.GraphedDecode(params, cfg, cache) if graphs else
                lambda t, p: M.decode_step(params, cfg, t, cache, p))
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for i in range(STEPS + 1):
            pos = torch.full((1,), prompt + i, dtype=torch.int32,
                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = step(nxt, pos)
            torch.cuda.synchronize()
            if i:              # the first step warms up (or captures)
                times.append((time.perf_counter() - t0) * 1e3)
            nxt = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    return times


def enqueue_us(torch, fn) -> list[float]:
    """Host us of ``ENQUEUE_REPS`` calls of ``fn``, each on an idle card."""
    for _ in range(3):
        fn()
    us = []
    for _ in range(ENQUEUE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    # ahead of the src/ that chip_smoke put on the path
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.convert import to_compute_dtype
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    graphs = (importlib.import_module("repro_torch.graphs")
              if importlib.util.find_spec("repro_torch.graphs") else None)

    cs.log(f"[time_decode] {cs.gpu_name_and_power()}; repro_torch from "
           f"{Path(ops.__file__).resolve().parents[1]}")
    runs = [(arch, None, prompt, max_seq, seed)
            for arch, prompt, _, max_seq, seed in cs.DECODE_FULL_WIDTH]
    runs += [(arch, layers, prompt, max_seq, seed)
             for arch, layers, prompt, _, max_seq, seed in cs.MOE_FULL_WIDTH]
    for arch, layers, prompt, max_seq, seed in runs:
        if prompt + STEPS + 1 > max_seq:
            raise ValueError(f"{arch}: {max_seq} cache rows do not hold "
                             f"{prompt} + {STEPS + 1}")
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = to_compute_dtype(M.init_params(gen, cfg, "cuda"),
                                  M.compute_dtype(cfg))
        torch.cuda.empty_cache()
        tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                               device="cuda", dtype=torch.int32)
        for arm in ("eager", "graphed"):
            if arm == "graphed" and graphs is None:
                cs.log(f"[time_decode] {arch}: graphed arm not run (the "
                       f"checkout has no repro_torch.graphs)")
                continue
            ms = step_times(torch, M, params, cfg, tokens, max_seq,
                            graphs if arm == "graphed" else None)
            cs.log(f"[time_decode] {arch} ({cfg.num_layers} layers) prompt "
                   f"{prompt} {arm}: median {statistics.median(ms)} ms per "
                   f"decoded token over {len(ms)} steps (min {min(ms)}, max "
                   f"{max(ms)})")
        del params
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, t, d, f, e, spec, _ in cs.GMM_FULL_WIDTH:
        if "decode" not in label:
            continue
        _, sizes, x, w = cs.gmm_inputs(torch, gen, t, d, f, e, spec,
                                       torch.bfloat16)
        us = enqueue_us(torch, lambda: ops.gmm(x, w, sizes))
        cs.log(f"[time_decode] gmm {label} T={t} D={d} F={f} E={e}: host "
               f"enqueue median {statistics.median(us)} us over {len(us)} "
               f"calls (min {min(us)}, max {max(us)})")
        del x, w
        torch.cuda.empty_cache()
    label, s, n, k, h, win, cap, pos_list = next(
        c for c in cs.DECODE_KERNEL_CASES if c[0] == "gemma2-2b global")
    q, kc, vc = cs.decode_inputs(torch, gen, len(pos_list), s, n, k, h,
                                 torch.bfloat16)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    us = enqueue_us(torch, lambda: ops.decode_attention(
        q, kc, vc, pos, window=win, softcap=cap))
    cs.log(f"[time_decode] decode_attention {label} bf16 S={s} N={n} K={k} "
           f"H={h} pos={pos_list}: host enqueue median "
           f"{statistics.median(us)} us over {len(us)} calls (min {min(us)}, "
           f"max {max(us)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
