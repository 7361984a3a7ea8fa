"""Capture a one-rank NCCL ``all_reduce`` in a CUDA graph under each
``capture_error_mode``, with the process group's watchdog holding the works
of eager collectives made just before the capture.

    python3 scripts/nccl_capture_modes.py [--calls 3000] [--eager 50]

Each mode and op runs in a process of its own (a failed capture can leave
the CUDA context unusable): a one-rank NCCL group over a ``HashStore``,
``--eager`` all_reduces, then ``--calls`` all_reduces captured in one graph
on a side stream, one replay on new data checked (AVG over one rank gives
the data back; SUM in place too), the kernels of one profiled replay, and
eager all_reduces after it. One line a mode and op: whether the capture
held, its host seconds, and the replay's kernels by name. Needs one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

MODES = ("global", "thread_local", "relaxed")
OPS = ("avg", "sum")


def probe(mode: str, op: str, calls: int, eager: int) -> None:
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rop = {"avg": dist.ReduceOp.AVG, "sum": dist.ReduceOp.SUM}[op]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        x = torch.zeros(1 << 16, device="cuda")
        for _ in range(eager):
            dist.all_reduce(x, op=rop)
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(g, stream=side, capture_error_mode=mode):
                for _ in range(calls):
                    dist.all_reduce(x, op=rop)
        except RuntimeError as e:
            print(f"[nccl] mode={mode} op={op} capture FAILED after "
                  f"{time.perf_counter() - t0:.3f} s: {e!r}"[:1500],
                  flush=True)
            return
        seconds = time.perf_counter() - t0
        new = torch.randn(x.shape, device="cuda")
        x.copy_(new)
        g.replay()
        torch.cuda.synchronize()
        equal = torch.equal(x, new)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            torch.cuda.synchronize()
            g.replay()
            torch.cuda.synchronize()
        rows = [(e.count, e.key[:100]) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        for _ in range(20):
            dist.all_reduce(x, op=rop)
        torch.cuda.synchronize()
        print(f"[nccl] mode={mode} op={op} capture of {calls} calls held in "
              f"{seconds:.3f} s, replay on new data equal {equal}, kernels "
              f"of one replay {rows}", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=3000)
    ap.add_argument("--eager", type=int, default=50)
    ap.add_argument("--mode", choices=MODES)
    ap.add_argument("--op", choices=OPS)
    args = ap.parse_args()
    if args.mode is not None:
        probe(args.mode, args.op, args.calls, args.eager)
        return 0
    import torch
    print(f"[nccl] torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    rc = 0
    for mode in MODES:
        for op in OPS:
            run = subprocess.run(
                [sys.executable, __file__, "--mode", mode, "--op", op,
                 "--calls", str(args.calls), "--eager", str(args.eager)],
                capture_output=True, text=True, timeout=300)
            lines = [ln for ln in run.stdout.splitlines()
                     if ln.startswith("[nccl]")]
            print("\n".join(lines) or f"[nccl] mode={mode} op={op} exited "
                  f"{run.returncode}: {run.stderr[-1500:]}", flush=True)
            rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
