#!/usr/bin/env python3
"""Measure what the 20 ms wait inside the profiling window does: profile
one bf16 decode-attention call many times in one process, half of the
profiles with no wait before the call and half with the wait, and count
the profiles that caught no device kernel at all.

    python3 scripts/profile_repeat.py

Each of ``SESSIONS`` sessions runs the call once unprofiled, then
profiles it twice under ``torch.profiler``, once for each wait in
``SETTLE_MS`` (the order alternating between sessions), and counts the
device events by the profiler's names (as the card tests'
``_kernel_names`` does). Every fifth session first captures and replays
a CUDA graph of the call, as the card tests do between their profiled
calls. The last line is one JSON object with the counts for each wait.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SESSIONS = 1000
SETTLE_MS = (0, 20)     # 20: the card tests' and chip_smoke.py's wait
GRAPH_EVERY = 5


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    # zamba2-2.7b's shared block: q [1, 32, 160] over a [1, 1056, 32, 160]
    # bf16 cache at pos 1040
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 32, 160), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((1, 1056, 32, 160), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    pos = torch.tensor([1040], dtype=torch.int32, device="cuda")

    def call():
        return ops.decode_attention(q, k, v, pos)

    def profiled(settle_ms: int) -> dict:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if settle_ms:
                time.sleep(settle_ms / 1e3)
                torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)}

    counts = {ms: {"settle_ms": ms, "profiles": 0, "empty": 0,
                   "one_kernel": 0, "other": 0} for ms in SETTLE_MS}
    for i in range(SESSIONS):
        if i % GRAPH_EVERY == 0:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                call()
            graph.replay()
            torch.cuda.synchronize()
            del graph
        call()
        torch.cuda.synchronize()
        for ms in SETTLE_MS[::1 if i % 2 else -1]:
            kernels = profiled(ms)
            c = counts[ms]
            c["profiles"] += 1
            if not kernels:
                c["empty"] += 1
            elif len(kernels) == 1 and sum(kernels.values()) == 1:
                c["one_kernel"] += 1
            else:
                c["other"] += 1
                print(f"session {i}, wait {ms} ms: {kernels}", flush=True)
    print(json.dumps({"sessions": SESSIONS, "graph_every": GRAPH_EVERY,
                      "by_wait": list(counts.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
