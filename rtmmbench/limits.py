"""The readings a cell's limits are set from, on the card: the program's
numbers over many seeds and the control's over a few, in one process.

    python3 -m rtmmbench.limits --workload vision.steady \
        --seeds 11,12,...  --control-seeds 21,22,23 --seconds 4

One set-up; then per program seed the weights are drawn anew into the same
buffers (the captured graphs keep their addresses), the engine serves the
cell's traffic for ``--seconds`` as a run does, and each served model's
held frames are compared with the float32 reference (``harness.logit_checks``);
a model or variant that served none in the window is called directly on
as many seeded prompts. Per control seed the same comparison is made of
the control: the reference (each model's reference module,
``harness.references``) with its weight products in float8
(``quant="fp8"``), at the same frame shapes. Prints
per number compared (``harness.frame_numbers``) the program's readings and
their largest (the lower reading) and the control's and their smallest
(the upper reading); for a routed model also the share of positions over
each gap of ``SHARES``, from which ``harness.SHARE_OVER`` is chosen.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

#: gaps over which a routed model's share of positions is printed
SHARES = (0.05, 0.1, 0.2, 0.3, 0.5)


def readings(config: dict, mix: dict, seeds: list[int],
             controls: list[int], seconds: float, device) -> dict:
    """{number compared: {"program": [...], "lower", "control": [...],
    "upper", "ratio"}} over ``seeds`` and ``controls``, after one set-up;
    a routed model's shares over each of ``SHARES`` as ``share<gap>.<m>``."""
    import numpy as np
    import torch

    from . import harness, traffic, weights
    from .trace import Tracer
    models, _ = harness.served_models(config)
    k = harness.HELD
    refs = harness.references(config)
    w = harness.make_weights(config, seeds[0], device, refs)
    recorder = harness.Recorder(seeds[0], k)
    handles = harness.build_handles(config, w, device, recorder,
                                    Tracer(False), refs)
    harness.capture(handles, config, mix, seeds[0], device)
    print(f"[limits] set-up {time.perf_counter() - T0:.1f} s", flush=True)

    def prompts(name, seed):
        rng = np.random.default_rng([seed, 11])
        vocab = models[name]["vocab_size"]
        seq = harness.stream_seq(mix, config, name)
        return [torch.from_numpy(rng.integers(0, vocab, (1, seq),
                                              dtype=np.int32)).to(device)
                for _ in range(k)]

    def shares(name, err):
        if not models[name].get("num_experts"):
            return {}
        return {f"share{g}.{name}": float((err > g).float().mean())
                for g in SHARES}

    program: dict[str, list] = {}
    for seed in seeds:
        weights.refill(w, seed)
        recorder.__init__(seed, k)
        engine = harness.make_engine(config, handles, mix, seed, device)
        queue = traffic.BenchQueue(mix, harness.vocab_of(config), seed,
                                   seconds)
        recorder.on = True
        engine.run(queue, duration_s=seconds + float(mix["drain_s"]))
        harness.sync(device)
        recorder.on = False
        held = dict(recorder.held)
        recorder.held = {}
        for name, h in handles.items():
            if name not in held:
                held[name] = [(t, h.fn(h.params, t))
                              for t in prompts(name, seed)]
        res = [(n, v) for n, v, _ in harness.logit_checks(config, w, held,
                                                          refs)]
        for name, got in held.items():
            if not models[name].get("num_experts"):
                continue
            worst: dict[str, float] = {}
            for t, logits in got:
                want = refs[name].forward(
                    harness.model_tree(config, w, name, refs), models[name],
                    t)
                err = harness.row_errors(logits, want)
                for n, v in shares(name, err).items():
                    worst[n] = max(worst.get(n, 0.0), v)
                del want
            res.extend(worst.items())
        for n, v in res:
            program.setdefault(n, []).append(v)
        print(f"[limits] seed {seed}: " + ", ".join(
            f"{n}={v!r}" for n, v in res), flush=True)
        del held, engine, queue
    control: dict[str, list] = {}
    for seed in controls:
        weights.refill(w, seed)
        res = []
        for name in models:
            tree = harness.model_tree(config, w, name, refs)
            forward = refs[name].forward
            worst = {}
            for t in prompts(name, seed):
                want = forward(tree, models[name], t)
                got = forward(tree, models[name], t, quant="fp8")
                err = harness.row_errors(got, want)
                nums = {f"{key}.{name}": v for key, v in
                        harness.frame_numbers(models[name], err).items()}
                for n, v in {**nums, **shares(name, err)}.items():
                    worst[n] = max(worst.get(n, 0.0), v)
            res.extend(worst.items())
        for n, v in res:
            control.setdefault(n, []).append(v)
        print(f"[limits] control seed {seed}: " + ", ".join(
            f"{n}={v!r}" for n, v in res), flush=True)
    summary = {}
    for name in sorted(set(program) | set(control)):
        lo = program.get(name, [])
        up = control.get(name, [])
        lower = max(lo) if lo else None
        upper = min(up) if up else None
        summary[name] = {"program": lo, "lower": lower,
                         "control": up, "upper": upper,
                         "ratio": upper / lower if lower and upper else None}
        print(f"[limits] {name}: lower {lower!r} (max of {len(lo)} "
              f"seeds), upper {upper!r} (min of {len(up)} control seeds), "
              f"upper/lower {summary[name]['ratio']!r}", flush=True)
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtmmbench.limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from . import harness
    if not torch.cuda.is_available():
        print("rtmmbench.limits: needs CUDA", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",")]
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    config = json.loads(harness.config_file(bench, cell["config"]).read_text())
    mix = json.loads(harness.traffic_file(cell["traffic"],
                                          cell["config"]).read_text())
    summary = readings(config, mix, seeds, controls, args.seconds, device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"workload": args.workload, "seeds": seeds,
                       "control_seeds": controls, "models": summary,
                       "card": torch.cuda.get_device_name(device)}, fh,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
