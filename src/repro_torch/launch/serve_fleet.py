"""Fleet serving: serving engines behind the global router, one thread and
one CUDA stream per node (port of ``examples/serve_fleet.py``).

The router policies of ``repro_torch.cluster.router`` place real-model
request streams across several ``ServingEngine`` instances ("nodes" with
different virtual accelerator slices). The router reads only the narrow
node surface (``node_id``, ``telemetry()``, and each stream's cost on a
node), so a thin adapter over each engine's *measured* latency table is
enough: the score formula the JAX package's fleet simulator runs on
offline cost tables runs here on measured numbers.

``--policy tuned_score`` closes the telemetry loop over real engines: the
run splits into ``--epochs`` serving epochs; each epoch re-places every
stream with the router's current weights, serves it, and feeds the realised
per-node deadline-violation rates back as a telemetry window
(``TunedScoreRouter.on_window``), the hindsight-scored coordinate probe
walking measured outcomes.

Concurrency model. Placement is sequential and deterministic, on the main
thread. Each epoch then serves every node that hosts a stream in its own
worker (one ``ThreadPoolExecutor`` worker per active node); each worker owns
one engine and one queue, the nodes share the model handles, whose
parameters are only read, and the reports are merged after the join, in
node order, so output and statistics do not depend on thread scheduling.
On CUDA:

  * each node owns one ``torch.cuda.Stream``, made once; its worker runs the
    engine inside ``torch.cuda.stream(node.cuda_stream)`` and checks that
    the stream is current and not the default one (``serve_node``). The
    kernel bindings launch on the current stream, so the nodes' work is
    ordered within each node only;
  * the engine's timed calls wait for the calling thread's current stream,
    not the device (``serving.engine._sync``): a node times its own work,
    not the other node's;
  * the kernels' launch counters are raised under one lock
    (``kernels.build.counter_lock``), so the counts of two threads add up;
  * the handles are built (``build.load()`` compiles the kernels) and each
    node's engine calibrated on the main thread, inside that node's stream,
    before any worker starts; the calibration's untimed first call captures
    each handle's CUDA graph for that stream (``graphs.GraphedForward``:
    one graph, memory pool and static buffer per stream), so that no
    capture lands inside an epoch, and the device is synchronised before
    the workers run.

A served call is one graph replay: its host work is a few Python calls
and one graph launch, not a launch per kernel, yet the engine's own Python
still holds the GIL. So each engine's calibrated ``lat_table``, measured
alone, may understate the latency it sees under two threads;
``chip_smoke.py`` measures both.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --duration 4 \\
        --policy tuned_score --epochs 3 [--device cpu] [--obs DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..cluster.node import NodeTelemetry, StreamCost
from ..cluster.router import RouterPolicy, make_policy
from ..cluster.telemetry import TelemetryWindow
from ..core.uxcost import WindowStats, uxcost
from ..obs import Obs
from ..serving import (EngineReport, ModelHandle, RequestQueue, ServeRequest,
                       ServingEngine, VirtualAccelerator)
from .serve import build_handle

#: two nodes of different virtual hardware: a big fast node and a frugal
#: node of small slices, the capacity heterogeneity the score router uses
NODE_SLICES = (
    ("big", (("big0", 1.0, 1.0), ("big1", 1.0, 1.0))),
    ("small", (("small0", 0.45, 0.4), ("small1", 0.45, 0.4))),
)
#: the example's six streams: (model, fps)
STREAMS = (("detector", 8.0), ("verifier", 6.0), ("context", 4.0),
           ("kws", 12.0), ("detector", 6.0), ("kws", 10.0))
POLICY_CHOICES = ("round_robin", "least_loaded", "score", "tuned_score")


class EngineNode:
    """Adapter: a ServingEngine viewed through the fleet-router surface,
    with the CUDA stream its worker serves on (None on the CPU)."""

    def __init__(self, node_id: int, name: str, engine: ServingEngine,
                 cuda_stream: "Optional[torch.cuda.Stream]" = None):
        self.node_id = node_id
        self.name = name
        self.engine = engine
        self.cuda_stream = cuda_stream
        self.streams: list["EngineStream"] = []
        self.offered_s = 0.0
        #: the raw handle of the stream the last worker served on
        self.served_on: Optional[int] = None

    def telemetry(self) -> NodeTelemetry:
        n_accs = len(self.engine.accs)
        return NodeTelemetry(
            node_id=self.node_id, system=self.name, n_accs=n_accs,
            queue_depth=0, active_streams=len(self.streams),
            backlog_s=0.0, offered_util=self.offered_s / n_accs,
            window_uxcost=0.0, window_dlv=0.0, utilization=0.0,
            drops=0, draining=False)

    def assign(self, stream: "EngineStream") -> None:
        self.streams.append(stream)
        self.offered_s += stream.cost_on(self).offered_s

    def busy_s(self) -> float:
        """Wall seconds the engine has spent in served model calls."""
        return sum(sum(s) for s in self.engine.lat_samples.values())


class EngineStream:
    """One FPS stream of a registered model, costed from measured tables."""

    def __init__(self, model: str, fps: float, seq: int = 32,
                 vocab: int = 128):
        self.model = model
        self.fps = fps
        self.seq = seq
        self.vocab = vocab

    def cost_on(self, node: EngineNode) -> StreamCost:
        iso = min(node.engine.lat_table[(self.model, a.name)]
                  for a in node.engine.accs)
        return StreamCost(iso_s=iso, offered_s=self.fps * iso,
                          urgency=iso * self.fps)


def make_nodes(device: torch.device,
               obs: Optional[Obs] = None) -> list[EngineNode]:
    """The two nodes of ``NODE_SLICES``, each with a CUDA stream of its own
    when ``device`` is CUDA; their engines record into ``obs``, tagged with
    the node's name."""
    return [EngineNode(i, name, ServingEngine([
        VirtualAccelerator(acc, speed=speed, power=power)
        for acc, speed, power in slices], obs=obs, obs_node=name),
        torch.cuda.Stream(device) if device.type == "cuda" else None)
        for i, (name, slices) in enumerate(NODE_SLICES)]


def make_streams(shapes: Optional[dict[str, tuple[int, int]]] = None
                 ) -> list[EngineStream]:
    """The six streams of ``STREAMS``; ``shapes`` maps a model to its
    (prompt length, vocab), (32, 128) when absent."""
    shapes = shapes or {}
    return [EngineStream(model, fps, *shapes.get(model, (32, 128)))
            for model, fps in STREAMS]


def _on_stream(node: EngineNode):
    return (torch.cuda.stream(node.cuda_stream)
            if node.cuda_stream is not None else contextlib.nullcontext())


def register_all(nodes: list[EngineNode], handles: list[ModelHandle],
                 calib: Callable[[ModelHandle], np.ndarray]) -> None:
    """Register and calibrate every handle on every node, on the calling
    thread, each node inside its own stream (where a graphed handle
    captures that stream's graph); then wait for the device, so that the
    workers start on finished set-up."""
    for node in nodes:
        with _on_stream(node):
            for h in handles:
                node.engine.register(h, calib(h))
    if any(n.cuda_stream is not None for n in nodes):
        torch.cuda.synchronize()


def place_streams(policy: RouterPolicy, nodes: list[EngineNode],
                  streams: list[EngineStream]) -> list[int]:
    """Place every stream in order on emptied nodes; the node id of each."""
    for node in nodes:
        node.streams = []
        node.offered_s = 0.0
    out = []
    for stream in streams:
        nid = policy.place(stream, nodes)
        next(n for n in nodes if n.node_id == nid).assign(stream)
        out.append(nid)
    return out


def serve_node(node: EngineNode, queue: RequestQueue,
               duration_s: float) -> EngineReport:
    """One node's epoch, run by its worker: on the node's own stream, which
    must be the current stream and not the default one."""
    with _on_stream(node):
        if node.cuda_stream is not None:
            cur = torch.cuda.current_stream(node.cuda_stream.device)
            if (cur != node.cuda_stream or cur == torch.cuda.default_stream(
                    node.cuda_stream.device)):
                raise RuntimeError(f"node {node.name}: serving on stream "
                                   f"{cur}, not its own")
            node.served_on = cur.cuda_stream
        return node.engine.run(queue, duration_s=duration_s)


def epoch_window(epoch: int, nodes, prev) -> TelemetryWindow:
    """Fold the epoch's engine stats into the telemetry-window shape the
    tuner consumes.  Windows are pure *deltas* (the TelemetryWindow
    contract): ``prev`` maps node_id -> per-model cumulative snapshots at
    the previous epoch boundary, and everything — frames, per-node DLV,
    the window UXCost — is computed from the difference."""
    node_dlv, node_frames = {}, {}
    delta = WindowStats()
    for node in nodes:
        snap = {name: (st.frames, st.violated, st.energy_j,
                       st.worst_energy_j)
                for name, st in node.engine.stats.per_model.items()}
        last = prev.get(node.node_id, {})
        nf = nv = 0
        for name, (f, v, e, w) in snap.items():
            pf, pv, pe, pw = last.get(name, (0, 0, 0.0, 0.0))
            if f - pf > 0 or w - pw > 0.0:
                # per-node namespacing: two nodes hosting one model name
                # stay separate entries in the epoch's UXCost
                d = delta.model(f"n{node.node_id}.{name}")
                d.frames = f - pf
                d.violated = v - pv
                d.energy_j = e - pe
                d.worst_energy_j = w - pw
            nf += f - pf
            nv += v - pv
        prev[node.node_id] = snap
        node_frames[node.node_id] = nf
        node_dlv[node.node_id] = nv / nf if nf > 0 else 0.0
    frames = sum(st.frames for st in delta.per_model.values())
    violated = sum(st.violated for st in delta.per_model.values())
    return TelemetryWindow(
        t0=float(epoch), t1=float(epoch + 1), frames=frames,
        violated=violated,
        dlv_rate=violated / frames if frames else 0.0,
        uxcost=uxcost(delta), node_dlv=node_dlv, node_frames=node_frames,
        backlog_p50=0.0, backlog_p90=0.0, backlog_max=0.0,
        migrations=0, xfer_j=0.0, stream_uxcost={},
        n_models=sum(1 for st in delta.per_model.values() if st.frames))


@dataclass
class FleetRun:
    """What ``serve_epochs`` measured, per epoch in order."""

    policy: RouterPolicy
    nodes: list[EngineNode]
    placements: list[list[int]] = field(default_factory=list)
    windows: list[TelemetryWindow] = field(default_factory=list)
    reports: list[dict[int, EngineReport]] = field(default_factory=list)
    #: per epoch: (node id, model) -> frames served with a result
    served: list[dict[tuple[int, str], int]] = field(default_factory=list)
    #: per epoch: wall seconds of the workers' join, and each node's busy
    #: seconds in served calls
    epoch_wall_s: list[float] = field(default_factory=list)
    busy_s: list[dict[int, float]] = field(default_factory=list)
    #: (node id, model) -> the last request served there with a result
    last_served: dict[tuple[int, str], ServeRequest] = field(
        default_factory=dict)
    fleet_stats: WindowStats = field(default_factory=WindowStats)

    @property
    def frames(self) -> int:
        return sum(st.frames for st in self.fleet_stats.per_model.values())


def serve_epochs(nodes: list[EngineNode], streams: list[EngineStream],
                 policy: RouterPolicy, epochs: int, per_epoch_s: float, *,
                 obs: Optional[Obs] = None,
                 log: Callable[[str], None] = print) -> FleetRun:
    """Place, serve (one worker per active node) and feed back, ``epochs``
    times. Each epoch's queues are dropped after it, keeping only the last
    served request of each (node, model)."""
    rng = np.random.default_rng(0)            # tuner distant-sample stream
    run = FleetRun(policy=policy, nodes=nodes)
    by_id = {n.node_id: n for n in nodes}
    prev: dict[int, dict] = {}
    m_frames = m_viol = m_dlv = None
    if obs is not None and obs.metrics is not None:
        m_frames = obs.metrics.counter(
            "serve_frames_total", "frames served", ("node", "model"))
        m_viol = obs.metrics.counter(
            "serve_violations_total", "deadline violations",
            ("node", "model"))
        m_dlv = obs.metrics.gauge(
            "serve_epoch_dlv", "epoch deadline-violation rate")
    log(f"[serve_fleet] policy={policy.name}, {epochs} epoch(s) x "
        f"{per_epoch_s:.2f}s")
    for epoch in range(epochs):
        # each epoch re-places every stream with the router's current
        # weights on fresh queues: the placement lever the tuner turns
        nids = place_streams(policy, nodes, streams)
        run.placements.append(nids)
        queues = {n.node_id: RequestQueue(clock=lambda: 0.0) for n in nodes}
        for i, (stream, nid) in enumerate(zip(streams, nids)):
            node = by_id[nid]
            q = queues[nid]
            # one engine hosts at most one queue stream per model name
            if stream.model not in q.streams:
                q.add_stream(stream.model, fps=stream.fps, batch=1,
                             seq=stream.seq, vocab=stream.vocab)
            else:
                st = q.streams[stream.model]
                st["fps"] += stream.fps      # fold arrival rates, but keep
                # the tightest *original* per-frame deadline: the summed
                # rate is not a deadline
                st["deadline"] = min(st["deadline"], 1.0 / stream.fps)
            log(f"[serve_fleet]   epoch {epoch} stream {i}: "
                f"{stream.model:>9s} @{stream.fps:4.1f}fps -> node "
                f"{node.name}")
            if obs is not None and obs.tracer is not None:
                obs.tracer.event("place", float(epoch), stream=i,
                                 model=stream.model, node=node.name,
                                 policy=policy.name)

        active = [n for n in nodes if n.streams]
        for node in nodes:
            if node not in active:
                log(f"[serve_fleet] node {node.name}: idle")
            # each run restarts the engine's clock at 0: slices must not
            # stay busy until a time of the previous epoch's clock
            for acc in node.engine.accs:
                acc.busy_until = 0.0
        busy0 = {n.node_id: n.busy_s() for n in nodes}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=max(len(active), 1)) as pool:
            futures = {n.node_id: pool.submit(serve_node, n,
                                              queues[n.node_id], per_epoch_s)
                       for n in active}
            reports = {nid: fut.result() for nid, fut in futures.items()}
        run.epoch_wall_s.append(time.perf_counter() - t0)
        run.busy_s.append({n.node_id: n.busy_s() - busy0[n.node_id]
                           for n in nodes})
        run.reports.append(reports)
        served: dict[tuple[int, str], int] = {}
        for node in active:                   # node order: deterministic
            log(f"[serve_fleet] node {node.name}: "
                f"{reports[node.node_id].summary()}")
            for r in queues[node.node_id].pending:
                if r.result is not None:
                    key = (node.node_id, r.model)
                    served[key] = served.get(key, 0) + 1
                    run.last_served[key] = r
        run.served.append(served)
        del queues                            # every frame's logits

        win = epoch_window(epoch, nodes, prev)
        run.windows.append(win)
        if obs is not None:
            if obs.tracer is not None:
                obs.tracer.span("epoch", float(epoch), float(epoch + 1),
                                dlv=win.dlv_rate, uxcost=win.uxcost,
                                frames=win.frames)
            if m_dlv is not None:
                m_dlv.set(win.dlv_rate)
        on_window = getattr(policy, "on_window", None)
        if on_window is not None:
            steps = policy.probe.steps
            on_window(win, rng)
            # the hindsight costs of the mini-cycle this window scored
            # (center first), when the window carried a signal
            costs = ([round(c, 4) for c, _ in policy.probe.results]
                     if policy.probe.steps > steps else "held")
            log(f"[serve_fleet]   epoch {epoch}: DLV={win.dlv_rate:.3f} "
                f"-> weights {[round(w, 3) for w in policy.weights]} "
                f"(commits={policy.probe.commits}, costs {costs})")

    for node in nodes:                        # node order: deterministic
        run.fleet_stats.merge(node.engine.stats)
    log(f"[serve_fleet] fleet UXCost = {uxcost(run.fleet_stats):.4f} over "
        f"{run.frames} frames ({len(nodes)} nodes, {epochs} epochs)")
    if obs is not None:
        if m_frames is not None:
            for node in nodes:
                for name, st in sorted(node.engine.stats.per_model.items()):
                    m_frames.inc(st.frames, node=node.name, model=name)
                    m_viol.inc(st.violated, node=node.name, model=name)
            obs.metrics.gauge(
                "serve_fleet_uxcost",
                "fleet UXCost at run end").set(uxcost(run.fleet_stats))
        if obs.tracer is not None:
            obs.tracer.finish(float(epochs))
    return run


def main(argv: Optional[list[str]] = None) -> FleetRun:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_fleet")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--policy", default="score", choices=POLICY_CHOICES)
    ap.add_argument("--epochs", type=int, default=0, help=(
        "serving epochs (re-place + serve + feed telemetry); defaults to "
        "3 for tuned_score, 1 otherwise"))
    ap.add_argument("--obs", default=None, metavar="DIR", help=(
        "export observability artifacts (placement/epoch spans, each "
        "engine's job and loop spans, and a Prometheus/JSON metrics "
        "snapshot) to this directory"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.epochs <= 0:
        args.epochs = 3 if args.policy == "tuned_score" else 1

    # observability: spans for placements and epochs, each engine's own
    # (its frames' jobs and its loop's phases, on that run's clock; the
    # fleet's spans carry epoch indices as their time axis), and a metrics
    # registry the serving loop publishes into
    obs = Obs.make({"profile": False} if args.obs else None)
    nodes = make_nodes(dev, obs)
    handles = [
        build_handle("gemma-2b", "detector", layers=2, device=dev),
        build_handle("qwen1.5-4b", "verifier", layers=2, device=dev),
        build_handle("gemma2-2b", "context", layers=4, device=dev),
        build_handle("mamba2-130m", "kws", layers=2, device=dev),
    ]
    calib = np.zeros((1, 32), np.int32)
    register_all(nodes, handles, lambda h: calib)
    run = serve_epochs(nodes, make_streams(), make_policy(args.policy),
                       args.epochs, args.duration / args.epochs, obs=obs)
    if obs is not None:
        paths = obs.export(args.obs)
        print(f"[serve_fleet] obs artifacts -> "
              f"{', '.join(sorted(paths.values()))}")
    return run


if __name__ == "__main__":
    main()
