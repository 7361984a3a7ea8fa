"""Multi-model RTMM serving engine with DREAM (MapScore) dispatch (port of
``repro/serving/engine.py``).

The engine owns:

  * a set of registered models (``ModelHandle``: params plus a logits fn),
  * virtual accelerator slices with per-slice speed and power factors and a
    measured-latency table per (model, slice): the "offline cost model"
    input of the paper, calibrated here by direct measurement,
  * a real-time request queue (periodic frames, FPS targets, deadlines,
    model-cascade dependencies),
  * the four DREAM engines: MapScore calculator, frame drop, adaptivity
    ((alpha, beta) UXCost feedback) and job assignment/dispatch,
  * straggler mitigation: a job whose wall clock exceeds a watermark is
    re-dispatched to the next-best slice.

Every timed model call ends in ``torch.cuda.synchronize()`` when the model
lives on CUDA (the counterpart of ``jax.block_until_ready``), and the prompt
goes host -> device inside the timed window. Energy is modeled as latency x
slice power weight.
"""
from __future__ import annotations

import itertools
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import ArchConfig
from ..core.mapscore import MapScoreParams
from ..core.uxcost import WindowStats, uxcost


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


@dataclass
class ServeRequest:
    rid: int
    model: str
    tokens: np.ndarray                  # [B, S] prompt batch
    arrival: float
    deadline: float
    depends_on: Optional[str] = None
    done: bool = False
    dropped: bool = False
    completion: Optional[float] = None
    result: Any = None
    energy: float = 0.0

    @property
    def violated(self) -> bool:
        return self.dropped or (self.completion is not None
                                and self.completion > self.deadline)


@dataclass
class RequestQueue:
    """Frame generator for registered model streams, strictly periodic
    from t=0."""

    clock: Callable[[], float]
    streams: dict[str, dict] = field(default_factory=dict)
    pending: list[ServeRequest] = field(default_factory=list)
    _rid: itertools.count = field(default_factory=itertools.count)

    def add_stream(self, model: str, fps: float, batch: int, seq: int,
                   vocab: int, deadline_frac: float = 1.0,
                   depends_on: Optional[str] = None,
                   trigger_prob: float = 1.0) -> None:
        # crc32, not hash(): string hashing is salted per process and would
        # make stream contents differ run to run
        rng = np.random.default_rng(zlib.crc32(model.encode()) & 0xFFFF)
        self.streams[model] = dict(
            fps=fps, batch=batch, seq=seq, vocab=vocab, next_t=0.0,
            deadline=deadline_frac / fps, depends_on=depends_on,
            trigger_prob=trigger_prob, rng=rng)

    def poll(self, now: float) -> list[ServeRequest]:
        """Emit any frames whose arrival time elapsed (head streams)."""
        out = []
        for name, st in self.streams.items():
            if st["depends_on"] is not None:
                continue
            while st["next_t"] <= now:
                t = st["next_t"]
                out.append(self._make(name, st, t))
                st["next_t"] = t + 1.0 / st["fps"]
        self.pending.extend(out)
        return out

    def trigger_dependents(self, parent: str, now: float) -> list[ServeRequest]:
        out = []
        for name, st in self.streams.items():
            if st["depends_on"] == parent and \
                    st["rng"].random() < st["trigger_prob"]:
                out.append(self._make(name, st, now))
        self.pending.extend(out)
        return out

    def _make(self, name: str, st: dict, t: float) -> ServeRequest:
        tokens = st["rng"].integers(
            0, st["vocab"], size=(st["batch"], st["seq"])).astype(np.int32)
        return ServeRequest(rid=next(self._rid), model=name, tokens=tokens,
                            arrival=t, deadline=t + st["deadline"],
                            depends_on=st["depends_on"])


# ---------------------------------------------------------------------------
# virtual accelerators (time-sliced executors)
# ---------------------------------------------------------------------------


@dataclass
class VirtualAccelerator:
    """One dispatch target: the single device with a speed/power factor, so
    that the heterogeneous-hardware scheduling problem is preserved."""

    name: str
    speed: float = 1.0          # relative throughput (1.0 = fastest)
    power: float = 1.0          # relative energy per unit work
    busy_until: float = 0.0
    last_model: Optional[str] = None
    total_busy: float = 0.0


@dataclass
class ModelHandle:
    name: str
    cfg: ArchConfig
    params: Any
    fn: Callable                # logits fn(params, tokens)
    supernet: tuple[str, ...] = ()   # lighter variant model names


def _params_device(params: Any) -> torch.device:
    """The device of the first tensor in a params tree."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class EngineReport:
    frames: int
    violated: int
    dropped: int
    redispatched: int
    uxcost: float
    dlv_rate: float
    energy: float
    per_model: dict[str, dict]
    alpha: float
    beta: float

    def summary(self) -> str:
        return (f"frames={self.frames} dlv={self.dlv_rate:.3f} "
                f"drops={self.dropped} redisp={self.redispatched} "
                f"uxcost={self.uxcost:.4f} energy={self.energy:.4f}")


class ServingEngine:
    def __init__(self, accelerators: list[VirtualAccelerator],
                 alpha: float = 1.0, beta: float = 1.0,
                 adaptivity: bool = True,
                 frame_drop: bool = True,
                 supernet_switch: bool = True,
                 max_drop_per_window: int = 2, drop_window: int = 10,
                 straggler_factor: float = 3.0,
                 stale_periods: float = 2.0,
                 seed: int = 0):
        self.accs = accelerators
        self.models: dict[str, ModelHandle] = {}
        self.devices: dict[str, torch.device] = {}
        self.lat_table: dict[tuple[str, str], float] = {}  # (model, acc) -> s
        self.params = MapScoreParams(alpha=alpha, beta=beta)
        self.adaptivity = adaptivity
        self.frame_drop = frame_drop
        self.supernet_switch = supernet_switch
        self.max_drop = max_drop_per_window
        self.drop_window = drop_window
        self.straggler_factor = straggler_factor
        self.stale_periods = stale_periods
        self.aborted = 0
        self.rng = np.random.default_rng(seed)
        self.drop_hist: dict[str, list[bool]] = {}
        self.stats = WindowStats()
        self.window_stats = WindowStats()
        self.redispatched = 0
        self.dropped = 0
        self._probe: list[tuple[float, np.ndarray]] = []
        self._probe_radius = 0.4
        self._lat_samples: dict[str, list[float]] = {}

    # ------------------------------------------------------------ registry
    def register(self, handle: ModelHandle, calibrate_tokens: np.ndarray
                 ) -> None:
        """Register a model and calibrate its per-slice latency (the
        offline-cost-model input of the paper, measured here)."""
        self.models[handle.name] = handle
        self.drop_hist[handle.name] = []
        dev = self.devices[handle.name] = _params_device(handle.params)
        # one untimed warm-up call, then twice timed
        t = torch.from_numpy(calibrate_tokens).to(dev)
        handle.fn(handle.params, t)
        _sync(dev)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            handle.fn(handle.params, t)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        base = float(np.median(times))
        for acc in self.accs:
            self.lat_table[(handle.name, acc.name)] = base / acc.speed

    # ------------------------------------------------------------ mapscore
    def _mapscore(self, req: ServeRequest, acc: VirtualAccelerator,
                  now: float) -> float:
        lat = self.lat_table[(req.model, acc.name)]
        lat_all = [self.lat_table[(req.model, a.name)] for a in self.accs]
        togo = float(np.mean(lat_all))
        slack = req.deadline - now
        urgency = min(togo / slack, 20.0) if slack > 1e-6 else 0.0
        latpref = sum(lat_all) / lat
        tq = max(now - req.arrival, 0.0)
        starv = tq / togo
        en = lat * acc.power
        en_all = [self.lat_table[(req.model, a.name)] * a.power
                  for a in self.accs]
        cswitch = 0.0 if acc.last_model == req.model else 0.2
        score_energy = sum(en_all) / en - cswitch
        return (urgency * latpref + self.params.alpha * starv
                + self.params.beta * score_energy)

    # ----------------------------------------------------------- frame drop
    def _try_drop(self, now: float) -> None:
        waiting = [r for r in self._waiting if not r.done]
        expected_viol = [
            r for r in waiting
            if min(self.lat_table[(r.model, a.name)] for a in self.accs)
            > max(r.deadline - now, 0.0)]
        if len(expected_viol) < 2:
            return
        best, best_ratio = None, 0.0
        for r in expected_viol:
            hist = self.drop_hist[r.model][-self.drop_window:]
            if sum(hist) >= self.max_drop:
                continue
            mtg = min(self.lat_table[(r.model, a.name)] for a in self.accs)
            ratio = mtg / max(r.deadline - now, 1e-6)
            if ratio > best_ratio:
                best, best_ratio = r, ratio
        if best is not None:
            best.done, best.dropped = True, True
            self.dropped += 1
            self._finish_stats(best)

    # ------------------------------------------------------------ adaptivity
    def _adapt(self, window_ux: float) -> None:
        center = np.array([self.params.alpha, self.params.beta])
        self._probe.append((window_ux, center.copy()))
        if len(self._probe) >= 4:
            self._probe.sort(key=lambda x: x[0])
            (u1, p1), (u2, p2) = self._probe[0], self._probe[1]
            w1, w2 = 1 / (u1 + 1e-9), 1 / (u2 + 1e-9)
            new = np.clip((w1 * p1 + w2 * p2) / (w1 + w2), 0.0, 2.0)
            self.params = MapScoreParams(alpha=float(new[0]),
                                         beta=float(new[1]))
            self._probe = []
            self._probe_radius = max(self._probe_radius * 0.7, 0.05)
        else:
            cand = np.clip(center + self.rng.uniform(
                -self._probe_radius, self._probe_radius, 2), 0.0, 2.0)
            self.params = MapScoreParams(alpha=float(cand[0]),
                                         beta=float(cand[1]))

    # -------------------------------------------------------------- running
    def _finish_stats(self, req: ServeRequest) -> None:
        st = self.window_stats.model(req.model)
        st.frames += 1
        st.violated += int(req.violated)
        st.energy_j += req.energy
        worst = max(self.lat_table[(req.model, a.name)] * a.power
                    for a in self.accs)
        st.worst_energy_j += worst
        hist = self.drop_hist[req.model]
        hist.append(req.dropped)
        if len(hist) > self.drop_window:
            hist.pop(0)

    def _pick_variant(self, req: ServeRequest, now: float) -> str:
        """Supernet switching: lightest-necessary weight-sharing variant."""
        handle = self.models[req.model]
        if not (self.supernet_switch and handle.supernet):
            return req.model
        slack = max(req.deadline - now, 0.0)
        best_lat = min(self.lat_table[(req.model, a.name)]
                       for a in self.accs)
        if best_lat <= slack:
            return req.model
        for variant in handle.supernet:          # ordered heavy -> light
            vlat = min(self.lat_table[(variant, a.name)] for a in self.accs)
            if vlat <= slack:
                return variant
        return handle.supernet[-1]

    def run(self, queue: RequestQueue, duration_s: float,
            window_s: float = 0.5) -> EngineReport:
        """Drive the engine on the real clock until duration_s elapses."""
        t_start = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t_start
        self._waiting: list[ServeRequest] = []
        next_window = window_s
        variant_counts: dict[str, int] = {}

        while True:
            now = now_fn()
            if now >= duration_s:
                break
            self._waiting.extend(queue.poll(now))
            self._waiting = [r for r in self._waiting if not r.done]
            # hygiene: a frame still waiting `stale_periods` past its
            # deadline-equivalent period is abandoned (counts violated)
            for r in self._waiting:
                period = r.deadline - r.arrival
                if now > r.deadline + self.stale_periods * period:
                    r.done, r.dropped = True, True
                    self.aborted += 1
                    self._finish_stats(r)
            self._waiting = [r for r in self._waiting if not r.done]
            if self.frame_drop:
                self._try_drop(now)
            ready = [r for r in self._waiting if not r.done]
            idle = [a for a in self.accs if a.busy_until <= now]
            if not ready or not idle:
                nxt = min([a.busy_until for a in self.accs
                           if a.busy_until > now] + [now + 1e-3])
                time.sleep(max(min(nxt - now, 1e-3), 1e-5))
                if now >= next_window:
                    wux = uxcost(self.window_stats)
                    if self.adaptivity and sum(
                            st.frames for st in
                            self.window_stats.per_model.values()):
                        self._adapt(wux)
                    self.stats.merge(self.window_stats)
                    self.window_stats = WindowStats()
                    next_window += window_s
                continue

            # job assignment: best (request, accelerator) MapScore pair
            best, best_score = None, -np.inf
            for r in ready:
                for a in idle:
                    s = self._mapscore(r, a, now)
                    if s > best_score:
                        best, best_score = (r, a), s
            req, acc = best
            run_as = self._pick_variant(req, now)
            variant_counts[run_as] = variant_counts.get(run_as, 0) + 1
            handle = self.models[run_as]
            tok = req.tokens
            if tok.shape[1] > 0:
                dev = self.devices[run_as]
                t0 = time.perf_counter()
                out = handle.fn(handle.params, torch.from_numpy(tok).to(dev))
                _sync(dev)
                wall = time.perf_counter() - t0
                req.result = out
            else:
                wall = 0.0
            # straggler mitigation: re-dispatch if way past expectation
            expect = self.lat_table[(run_as, acc.name)]
            samples = self._lat_samples.setdefault(run_as, [])
            samples.append(wall)
            if wall > self.straggler_factor * expect and len(samples) > 4:
                alt = min((a for a in self.accs if a is not acc),
                          key=lambda a: self.lat_table[(run_as, a.name)],
                          default=None)
                if alt is not None:
                    self.redispatched += 1
                    acc = alt
            # virtual time accounting (speed factor models slice size)
            vlat = max(wall, self.lat_table[(run_as, acc.name)])
            done_at = now + vlat
            acc.busy_until = done_at
            acc.total_busy += vlat
            acc.last_model = run_as
            req.energy = vlat * acc.power
            req.done = True
            req.completion = done_at
            self._finish_stats(req)
            self._waiting.extend(queue.trigger_dependents(req.model, done_at))

        self.stats.merge(self.window_stats)
        self.window_stats = WindowStats()
        frames = sum(st.frames for st in self.stats.per_model.values())
        viol = sum(st.violated for st in self.stats.per_model.values())
        energy = sum(st.energy_j for st in self.stats.per_model.values())
        per_model = {
            name: dict(frames=st.frames, violated=st.violated,
                       energy=st.energy_j)
            for name, st in self.stats.per_model.items()}
        return EngineReport(
            frames=frames, violated=viol, dropped=self.dropped,
            redispatched=self.redispatched,
            uxcost=uxcost(self.stats),
            dlv_rate=viol / frames if frames else 0.0,
            energy=energy, per_model=per_model,
            alpha=self.params.alpha, beta=self.params.beta)
