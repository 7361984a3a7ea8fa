"""The knee of a configuration under a traffic mix: one set-up, then one
window per factor on the head streams' rates, on the card.

    python3 -m rtmmbench.sweep --config rtmm_vision --traffic steady \
        --factors 2,3,4,5,6 --seconds 8 --seed 7

For each factor it prints the frames that arrived in the window, the share
of them served by their deadline, the frames waiting at the window's
middle and at its end, and the 95th percentile of the frames' latency.
The knee is the highest factor at which at least 99% met their deadlines
and the frames waiting over the window's last tenth were, on average, no
more than over its middle tenth plus one (the frame in service): the
backlog did not grow. The traffic file's rates
are set from it by hand (``fps`` = 0.8 x knee x the file's base rate).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def sweep(config: dict, mix: dict, factors: list[float], seconds: float,
          seed: int, device) -> tuple[list[dict], float | None]:
    """One set-up, one window per factor: (a row per factor, the knee)."""
    from . import harness, traffic
    from .trace import Tracer
    refs = harness.references(config)
    w = harness.make_weights(config, seed, device, refs)
    handles = harness.build_handles(config, w, device,
                                    harness.Recorder(seed, 0), Tracer(False),
                                    refs)
    harness.capture(handles, config, mix, seed, device)
    print(f"[sweep] set-up {time.perf_counter() - T0:.1f} s", flush=True)
    rows = []
    for f in factors:
        engine = harness.make_engine(config, handles, mix, seed, device)
        queue = traffic.BenchQueue(mix, harness.vocab_of(config), seed,
                                   seconds, rate_factor=f)
        engine.run(queue, duration_s=seconds + float(mix["drain_s"]))
        harness.sync(device)
        queue.close()
        frames = traffic.window_frames(queue.frames, seconds)
        met = sum(1 for x in frames if x.met)
        p95, n = traffic.frame_p95_ms(queue.frames, seconds)
        row = {"factor": f, "frames": len(frames),
               "met_share": met / max(len(frames), 1),
               "waiting_mid": queue.waiting.get("mid"),
               "waiting_end": queue.waiting.get("end"),
               "frame_p95_ms": p95, "served": n,
               "dropped": engine.dropped, "aborted": engine.aborted,
               "served_by": {m: len(v) for m, v in
                             engine.lat_samples.items()}}
        rows.append(row)
        print(f"[sweep] {json.dumps(row)}", flush=True)
    ok = [r["factor"] for r in rows if r["met_share"] >= 0.99
          and (r["waiting_end"] or 0) <= (r["waiting_mid"] or 0) + 1]
    return rows, max(ok) if ok else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtmmbench.sweep")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="steady")
    ap.add_argument("--factors", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from . import harness
    if not torch.cuda.is_available():
        print("rtmmbench.sweep: needs CUDA", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    config = json.loads(harness.config_file(bench, args.config).read_text())
    mix = json.loads(harness.traffic_file(args.traffic,
                                          args.config).read_text())
    rows, knee = sweep(config, mix, [float(x) for x in
                                     args.factors.split(",")],
                       args.seconds, args.seed, device)
    print(f"[sweep] knee factor {knee} on "
          f"{torch.cuda.get_device_name(device)}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"config": args.config, "traffic": args.traffic,
                       "seconds": args.seconds, "rows": rows, "knee": knee,
                       "card": torch.cuda.get_device_name(device)}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
