"""One cell of the benchmark: set-up, the measured window, the metrics and
the check of what the window served.

Set-up makes the configuration's weights from the seed on the device
(``weights``), builds one ``ModelHandle`` per served model and supernet
variant (``models.model.forward`` on the kernels, replayed from CUDA graphs
by ``graphs.GraphedForward``; each variant a view of its model's first
layer groups), captures each graph at its frame shape, and registers every
handle with a ``ServingEngine`` (DREAM on: MapScore, frame drop, supernet
switching, adaptivity), whose calibration times the replays. The window is
``ServingEngine.run`` over the benchmark's queue (``traffic.BenchQueue``):
arrivals for ``seconds``, then ``drain_s`` more in which the engine
finishes, drops or abandons every frame that arrived.

The check (``logit_checks``, ``accounting_check``) holds the logits of a seeded sample of each model's
calls in the window (``Recorder``) and, once the window has closed, the
peak memory read and the program's graphs freed, compares them with the
plain float32 reference on the same weights and prompts; and compares the
engine's report of frames and violations per stream with the benchmark's
count from its frame records.

Each served model has a reference module (``references``): the one its
model entry names under ``reference``, ``reference.model`` where it names
none. A configuration may bring its own as a new file of ``reference/``.
The module lays out the model's weights, cuts its supernet variants, gives
the reference's logits and counts a call's operations and bytes (the
``mfu`` and ``*_roofline`` readers' work, through ``RunData``); the
harness goes through it for each of these and knows no architecture.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Optional

import numpy as np
import torch

from . import ROOT, counts, traffic, weights
from .trace import Timeline, Tracer

PKG = Path(__file__).resolve().parent
#: top-level module names that may not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: window calls of each served model held for the check
HELD = 3
#: the gap over which a position of a routed model counts in its
#: ``logit_share``
SHARE_OVER = 0.5
#: the reference module of a model entry that names none
DEFAULT_REFERENCE = "model"
#: what a reference module serves (``reference``'s docstring)
CONTRACT = ("check_config", "param_layout", "forward", "variant_tree",
            "call_counts")


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(bench: dict, config: str, root: Path = ROOT) -> Path:
    for c in bench["configs"]:
        if c["name"] == config:
            return root / c["file"]
    raise KeyError(f"no configuration {config!r} in BENCHMARK.json")


def traffic_file(mix: str, config: str, pkg: Path = PKG) -> Path:
    return pkg / "traffic" / mix / f"{config}.json"


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind="end_to_end"``) or per-layer metrics:
    those that list it under ``workloads``, or list none."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``'s ``read``."""
    return importlib.import_module(f"{__package__}.metrics.{metric}").read


def reference_module(entry: dict, name: str) -> ModuleType:
    """The reference module of model entry ``entry`` (served as ``name``):
    ``reference/<entry["reference"]>.py``, ``reference/model.py`` where the
    entry names none, checked against ``CONTRACT``; a ``ValueError`` naming
    the entry where it is missing or incomplete."""
    mod = entry.get("reference", DEFAULT_REFERENCE)
    if not isinstance(mod, str) or not mod.isidentifier():
        raise ValueError(f"{name}: reference {mod!r} is not a module name")
    full = f"{__package__}.reference.{mod}"
    try:
        module = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"{name}: no reference module {mod!r} "
                         f"(rtmmbench/reference/{mod}.py)") from None
    missing = [f for f in CONTRACT if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"{name}: reference module {mod!r} lacks "
                         f"{', '.join(missing)}")
    return module


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def served_models(config: dict) -> tuple[dict[str, dict], dict[str, tuple]]:
    """({served model or variant: its model entry}, {model: its supernet
    variants, heavy to light}). A variant is its model's entry with the
    variant's keys (its depth) replaced."""
    models, supernet = {}, {}
    for role in config["serves"]:
        entry = config[role]
        models[role] = entry["config"]
        variants = entry.get("supernet", {})
        supernet[role] = tuple(variants)
        for name, over in variants.items():
            models[name] = {**entry["config"], **over}
    return models, supernet


def base_of(config: dict, name: str) -> str:
    """The served model a variant belongs to (itself for a model)."""
    for role in config["serves"]:
        if name == role or name in config[role].get("supernet", {}):
            return role
    raise KeyError(name)


def references(config: dict) -> dict[str, ModuleType]:
    """{served model or variant: its reference module}, a variant's its
    model's: each module checked against the contract
    (``reference_module``) and each model against its module's
    ``check_config``, at set-up before any weights are drawn; a
    ``ValueError`` names the model entry."""
    refs = {}
    for role in config["serves"]:
        ref = reference_module(config[role], role)
        for name in (role, *config[role].get("supernet", {})):
            refs[name] = ref
    models, _ = served_models(config)
    for name, cfg in models.items():
        try:
            refs[name].check_config(cfg)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
    return refs


def make_weights(config: dict, seed: int, device: torch.device,
                 refs: dict[str, ModuleType]) -> weights.Weights:
    """The served models' weights from ``seed`` in the configuration's
    dtype, each laid out by its reference module."""
    return weights.make({r: config[r]["config"] for r in config["serves"]},
                        refs, seed, device, getattr(torch, config["dtype"]))


def arch_config(name: str, cfg: dict, dtype: str):
    """The program's ``ArchConfig`` of a model entry: every key of the
    entry is one of its fields."""
    from repro_torch.configs import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    unknown = set(cfg) - fields
    if unknown:
        raise ValueError(f"{name}: keys {sorted(unknown)} are not "
                         f"ArchConfig fields")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    return ArchConfig(name=name, dtype=dtype, scan_layers=False, **kw)


def check_layout(name: str, cfg: dict, acfg, ref: ModuleType) -> None:
    """The program's parameter tree has the leaves and shapes of the
    reference module ``ref``'s layout."""
    from repro_torch.models import model as M

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)
    program = dict(flat(M.param_spec(acfg)))
    ours = {tuple(p): tuple(s) for p, s, _, _ in ref.param_layout(cfg)}
    if program != ours:
        raise ValueError(f"{name}: the program's parameter tree differs from "
                         f"the reference's: {sorted(set(program) ^ set(ours))}")


# ---------------------------------------------------------------------------
# the program's handles
# ---------------------------------------------------------------------------


class Recorder:
    """A seeded uniform sample (reservoir) of ``k`` calls per served model
    while ``on``: (prompt, logits) on the device, the rest let go."""

    def __init__(self, seed: int, k: int):
        self.seed, self.k = seed, k
        self.on = False
        self.calls: dict[str, int] = {}
        self.held: dict[str, list] = {}
        self._rng: dict[str, np.random.Generator] = {}

    def offer(self, name: str, tokens: torch.Tensor,
              out: torch.Tensor) -> None:
        if not self.on:
            return
        n = self.calls[name] = self.calls.get(name, 0) + 1
        held = self.held.setdefault(name, [])
        if len(held) < self.k:
            held.append((tokens, out))
            return
        rng = self._rng.setdefault(name, np.random.default_rng(
            [self.seed, 7, zlib.crc32(name.encode())]))
        j = int(rng.integers(0, n))
        if j < self.k:
            held[j] = (tokens, out)


def build_handles(config: dict, w: weights.Weights, device: torch.device,
                  recorder: Recorder, tracer: Tracer,
                  refs: dict[str, ModuleType]) -> dict:
    """One ``ModelHandle`` per served model and variant, their graphs not
    captured yet."""
    from repro_torch.graphs import GraphedForward
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serving import ModelHandle

    if device.type == "cuda":
        build.load()
    models, supernet = served_models(config)
    handles = {}
    for name, cfg in models.items():
        acfg = arch_config(name, cfg, config["dtype"])
        check_layout(name, cfg, acfg, refs[name])
        tree = model_tree(config, w, name, refs)

        @torch.inference_mode()
        def forward(p, tokens, acfg=acfg):
            return M.forward(p, acfg, tokens)[0]
        graphed = GraphedForward(forward) if device.type == "cuda" else forward

        def fn(p, tokens, name=name, graphed=graphed):
            with tracer.span(f"call:{name}"):
                out = graphed(p, tokens)
            recorder.offer(name, tokens, out)
            return out
        handles[name] = ModelHandle(name=name, cfg=acfg, params=tree, fn=fn,
                                    supernet=supernet.get(name, ()))
    return handles


def stream_seq(mix: dict, config: dict, name: str) -> int:
    """The frame length a served model or variant is called at."""
    return int(mix["streams"][base_of(config, name)]["seq"])


def make_engine(config: dict, handles: dict, mix: dict, seed: int,
                device: torch.device):
    """A ``ServingEngine`` over the configuration's slices with every handle
    registered (calibrated at its frame shape)."""
    from repro_torch.serving import ServingEngine, VirtualAccelerator
    accs = [VirtualAccelerator(s["name"], speed=s["speed"], power=s["power"])
            for s in config["slices"]]
    engine = ServingEngine(accs, seed=seed, **config["engine"])
    for name, h in handles.items():
        engine.register(h, calibration_tokens(config, mix, name, seed))
    return engine


def calibration_tokens(config: dict, mix: dict, name: str,
                       seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 9, zlib.crc32(name.encode())])
    vocab = config[base_of(config, name)]["config"]["vocab_size"]
    return rng.integers(0, vocab, size=(1, stream_seq(mix, config, name)),
                        dtype=np.int32)


def capture(handles: dict, config: dict, mix: dict, seed: int,
            device: torch.device, calls: int = 20) -> None:
    """Each handle's graph captured at its frame shape, and replayed until
    the card is warm, before the engine times it."""
    for name, h in handles.items():
        t = torch.from_numpy(calibration_tokens(config, mix, name,
                                                seed)).to(device)
        for _ in range(calls):
            h.fn(h.params, t)
    sync(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def vocab_of(config: dict) -> dict[str, int]:
    return {role: config[role]["config"]["vocab_size"]
            for role in config["serves"]}


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


@dataclass
class RunData:
    """What a per-layer metric's reader reads."""

    timeline: Optional[Timeline]
    models: dict[str, dict]            # served model or variant -> entry
    seq: dict[str, int]                # frame length of each
    calls: dict[str, int]              # calls in the run, by model
    walls: dict[str, list[float]]      # the engine's lat_samples
    frames: int                        # frames served (calls made)
    refs: dict[str, ModuleType]        # reference module of each model

    def call_flops(self) -> float:
        """The calls' operations, each model's by its reference module."""
        return sum(n * self.refs[m].call_counts(self.models[m],
                                                self.seq[m])["flops"]
                   for m, n in self.calls.items())

    def kernel_bound_s(self, kernel: str) -> float:
        """The calls' least seconds for ``kernel``'s launches, each model's
        counted by its reference module."""
        total = 0.0
        for m, n in self.calls.items():
            b = counts.kernel_bound_s(self.models[m], self.seq[m], kernel,
                                      self.refs[m].call_counts)
            total += n * (b or 0.0)
        return total

    def wall_s(self) -> float:
        return sum(sum(v) for v in self.walls.values())


@dataclass
class Outcome:
    """A run's result line, and each number compared: (name, value,
    limit)."""

    line: dict
    checks: list[tuple[str, float, float]]


def log(msg: str) -> None:
    """An earlier line of the run's standard output."""
    print(f"[rtmmbench] {msg}", flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, bench: Optional[dict] = None,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             root: Path = ROOT) -> Outcome:
    """Run one cell and return its result line. ``config`` and ``mix``
    stand in for the cell's files where given (the CPU rehearsals)."""
    bench = bench if bench is not None else load_benchmark(root)
    cell = find_cell(bench, workload)
    if config is None:
        config = json.loads(config_file(bench, cell["config"],
                                        root).read_text())
    if mix is None:
        mix = json.loads(traffic_file(cell["traffic"],
                                      cell["config"]).read_text())
    models, _ = served_models(config)
    seq = {m: stream_seq(mix, config, m) for m in models}

    # ------------------------------------------------------------ set-up
    refs = references(config)
    w = make_weights(config, seed, device, refs)
    recorder = Recorder(seed, HELD)
    tracer = Tracer(trace, seconds, calls=lambda: dict(recorder.calls))
    handles = build_handles(config, w, device, recorder, tracer, refs)
    capture(handles, config, mix, seed, device)
    engine = make_engine(config, handles, mix, seed, device)
    queue = traffic.BenchQueue(mix, vocab_of(config), seed, seconds,
                               span=tracer.span, clock=tracer.clock)
    first = next(iter(handles.values()))
    tracer.warm(lambda: first.fn(first.params, torch.from_numpy(
        calibration_tokens(config, mix, first.name, seed)).to(device)))
    sync(device)
    gc.collect()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: weights {w.nbytes} bytes, "
        f"{len(handles)} handles, calibrated ms "
        + ", ".join(f"{k[0]}@{k[1]}={v * 1e3:.4f}"
                    for k, v in sorted(engine.lat_table.items())))

    # ------------------------------------------------------------ window
    if device.type == "cuda":
        mem_start = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    gc.freeze()
    recorder.on = True
    report = engine.run(queue, duration_s=seconds + float(mix["drain_s"]))
    sync(device)
    queue.close()
    recorder.on = False
    gc.unfreeze()
    t_read = time.perf_counter()
    timeline = tracer.finish()
    if timeline is not None:
        log(f"trace: {len(timeline.device)} device operations in the "
            f"traced window, read in {time.perf_counter() - t_read:.1f} s")
    left = forbidden_modules()
    if left:
        raise ForbiddenModules(left)

    # ------------------------------------------------------------ metrics
    frames = queue.frames
    p95, n_lat = traffic.frame_p95_ms(frames, seconds)
    good = traffic.goodput_fps(frames, seconds)
    in_window = traffic.window_frames(frames, seconds)
    served = sum(1 for f in in_window if f.served)
    failed = sum(1 for f in in_window if not f.served)
    log(f"frame_p95_ms over {n_lat} served frames of {len(in_window)} "
        f"that arrived in the {seconds} s window; goodput "
        f"{good * seconds:.0f} frames by their deadline")
    log(latency_profile(frames, seconds, engine.lat_table))
    log(f"engine: {report.summary()}; aborted {engine.aborted}; "
        f"variants served {dict(sorted(recorder.calls.items()))}; final "
        f"(alpha, beta) ({report.alpha}, {report.beta}); waiting at the "
        f"window's middle {queue.waiting.get('mid')}, end "
        f"{queue.waiting.get('end')}")
    device_info: dict[str, Any] = {"platform": "gpu", "kind": None,
                                   "count": 1, "memory_peak_bytes": 0}
    if device.type == "cuda":
        device_info["kind"] = torch.cuda.get_device_name(device)
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
        log(f"device memory: {mem_start} bytes allocated at the "
            f"window's start, {torch.cuda.memory_allocated(device)} at its "
            f"end, peak in the window "
            f"{torch.cuda.max_memory_allocated(device)}")
    else:
        device_info["platform"] = "cpu"
    metrics: dict[str, dict] = {}
    breakdown = None
    if trace:
        # the calls inside the traced window: the engine's i-th timed call
        # of a model is the recorder's i-th
        lo, hi = tracer.at["window_start"], tracer.at["window_end"]
        calls = {m: n - lo.get(m, 0) for m, n in hi.items()
                 if n > lo.get(m, 0)}
        walls = {m: engine.lat_samples[m][lo.get(m, 0):hi[m]] for m in calls}
        data = RunData(timeline, models, seq, calls, walls,
                       sum(calls.values()), refs)
        for m in cell_metrics(bench, workload, "per_layer"):
            value = reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo_ns, hi_ns = timeline.window()
        device_info["busy_s"] = timeline.busy_s()
        device_info["window_s"] = (hi_ns - lo_ns) / 1e9
        breakdown = {"device_ops": timeline.top_ops(),
                     "idle_gaps": timeline.idle_gaps()}
    else:
        values = {"frame_p95_ms": p95, "goodput_fps": good,
                  "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # ------------------------------------------------------------ the check
    held = recorder.held
    del engine, handles, recorder
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = logit_checks(config, w, held, refs)
    checks.append(accounting_check(report, frames))
    correct = all(v <= lim for _, v, lim in checks)
    line = {"correct": correct, "attempted": len(in_window),
            "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return Outcome(line, checks)


def latency_profile(frames: list, seconds: float, lat_table: dict) -> str:
    """Per stream: served frames, the median and 95th percentile of the
    latency (ms), the same of the engine's ``completion - arrival``, and
    the share served on a slower slice (whose completion the engine
    models at its calibrated latency over its speed, so that a frame's
    energy falls below the fastest slice's calibrated latency)."""
    parts = []
    for name in sorted({f.model for f in frames}):
        fs = [f for f in traffic.window_frames(frames, seconds)
              if f.model == name and f.served]
        if not fs:
            continue
        lat = np.array([(f.served_s - f.arrival) * 1e3 for f in fs])
        eng = np.array([(f.completion - f.arrival) * 1e3 for f in fs])
        fastest = min(v for (m, _), v in lat_table.items() if m == name)
        slow = sum(1 for f in fs if f.energy < 0.95 * fastest)
        parts.append(f"{name}: {len(fs)} served, p50 "
                     f"{np.percentile(lat, 50):.3f} p95 "
                     f"{np.percentile(lat, 95):.3f} ms (the engine's "
                     f"{np.percentile(eng, 50):.3f}, "
                     f"{np.percentile(eng, 95):.3f}), on a slower slice "
                     f"{slow / len(fs):.3f}")
    return "latency " + "; ".join(parts)


class ForbiddenModules(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The relative L2 gap of the program's logits from the reference's at
    each position of a frame."""
    got = got.reshape(want.shape).float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)


def frame_numbers(cfg: dict, err: torch.Tensor) -> dict[str, float]:
    """The numbers compared of one frame, from its per-position gaps:
    the widest (``logit_err``); for a model with routed experts the share
    of positions over ``SHARE_OVER`` (``logit_share``). Its routing is a
    discrete choice that rounding flips at near ties, and a flipped
    token's row, and the rows that attend to it, differ from the
    reference's in sound runs, more so layer after layer: at 20 layers
    sound runs read median gaps of 0.13-0.25 against the control's
    0.39-0.42, too close for a limit, while the share of positions over
    0.5 reads 0.02-0.06 against 0.23-0.27, and rises with any wrong
    minority of rows."""
    if cfg.get("num_experts"):
        return {"logit_share": float((err > SHARE_OVER).float().mean())}
    return {"logit_err": float(err.max())}


def model_tree(config: dict, w: weights.Weights, name: str,
               refs: dict[str, ModuleType]) -> dict:
    """The weights a served model or variant runs on: a variant's cut from
    its model's by its reference module's ``variant_tree``."""
    base = base_of(config, name)
    tree = w.trees[base]
    if name != base:
        models, _ = served_models(config)
        tree = refs[name].variant_tree(tree, models[name])
    return tree


def logit_checks(config: dict, w: weights.Weights, held: dict,
                 refs: dict[str, ModuleType]
                 ) -> list[tuple[str, float, float]]:
    """(``<number>.<model>``, value, limit) of each served model: each of
    its ``frame_numbers`` over the held frames against the reference, the
    largest over the frames, against its reference module's ``forward``;
    the limits are the configuration's ``limits`` by that name."""
    models, _ = served_models(config)
    limits = config.get("limits", {})
    out = []
    for name in sorted(held):
        cfg = models[name]
        tree = model_tree(config, w, name, refs)
        worst: dict[str, float] = {}
        rows, routed = [], []  # routed: (live, flips) a layer
        for tokens, logits in held[name]:
            want = refs[name].forward(tree, cfg, tokens, routed=routed)
            err = row_errors(logits, want)
            rows.append(err)
            for key, v in frame_numbers(cfg, err).items():
                worst[key] = max(worst.get(key, 0.0), v)
            del want
        rows = torch.cat(rows)
        q = torch.quantile(rows, torch.tensor([0.5, 0.9, 0.99],
                                              device=rows.device))
        log(f"{name}: per-position logit gaps over {len(held[name])} "
            f"held frames: median {float(q[0])}, p90 {float(q[1])}, p99 "
            f"{float(q[2])}, max {float(rows.max())}, share over "
            f"{SHARE_OVER} {float((rows > SHARE_OVER).float().mean())}")
        if routed:
            log(f"{name}: per MoE layer of each held frame, (experts "
                f"receiving rows, tokens whose routing bf16 rounding of the "
                f"router's operands flips): {routed}")
        for key, v in worst.items():
            check = f"{key}.{name}"
            out.append((check, v, float(limits.get(check, float("-inf")))))
    return out


def accounting_check(report, frames: list) -> tuple[str, float, float]:
    """(``accounting_mismatch``, value, 0): frames and violations per
    stream in the engine's report against the frame records' count."""
    mine = traffic.accounting(frames)
    theirs = {k: {"frames": v["frames"], "violated": v["violated"]}
              for k, v in report.per_model.items()}
    mismatch = 0
    for name in set(mine) | set(theirs):
        a = mine.get(name, {"frames": 0, "violated": 0})
        b = theirs.get(name, {"frames": 0, "violated": 0})
        mismatch += abs(a["frames"] - b["frames"]) + abs(a["violated"]
                                                         - b["violated"])
    log(f"accounting: records {dict(sorted(mine.items()))}; engine "
        f"{dict(sorted(theirs.items()))}")
    return ("accounting_mismatch", float(mismatch), 0.0)
