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

Every timed model call, the calibration's included, ends by waiting for the
calling thread's current CUDA stream when the model lives on CUDA (the
counterpart of ``jax.block_until_ready`` on the call's output), and the
prompt goes host -> device inside the timed window. Waiting for the stream
and not the device is what lets engines serve concurrently, one thread and
one stream each (``launch.serve_fleet``): each times its own work, not the
other engines'. Energy is modeled as latency x slice power weight.

With ``obs`` (a ``repro_torch.obs.Obs`` whose ``tracer`` is set) a run
records into the tracer, on the engine's clock (seconds since the run's
start), every span tagged with ``run`` (the ``engine.run`` span's id) and
``node`` (``obs_node``), so that one tracer may serve several engines:

  ==================  =====================================================
  kind                recorded
  ==================  =====================================================
  ``engine.run``      the run; ``clock``: two (engine seconds, Unix ns)
                      pairs read back to back at its start and end, which
                      map the run's spans onto the Unix clock
  ``job``             one per frame, from its arrival (``origin``) to its
                      hand-over, drop, abandonment or the run's end
                      (``outcome`` done / dropped / aborted / unfinished);
                      ``segs`` ``[[dispatch, hand-over]]``, so that its
                      queue segment is the frame's wait
  ``engine.wait``     consecutive passes of the loop that dispatch nothing
                      (poll, hygiene, drop, adaptivity, sleep)
  ``engine.decide``   a dispatching pass up to the call: poll, hygiene,
                      drop, MapScore over every (ready, idle) pair
                      (``evals``), the variant
  ``engine.enqueue``  the model call up to its return
  ``engine.sync``     the wait on the stream, up to the hand-over
  ``engine.after``    re-dispatch check, accounting, cascade triggers, up
                      to the next pass
  ``engine.window``   (event) an adaptivity window's UXCost and frames
                      under the (alpha, beta) it ran with
  ==================  =====================================================

The loop's spans follow one another without overlap. Tracing draws no
random number and no value it reads flows back into a decision; with
``obs`` off each site costs one ``is not None`` test.
"""
from __future__ import annotations

import copy
import itertools
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs import ArchConfig
from ..core.mapscore import MapScoreParams
from ..core.uxcost import WindowStats, uxcost
from ..scenarios.arrivals import arrival_from_config


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
    """Frame generator for registered model streams.

    Streams are strictly periodic from t=0 by default; pass ``arrival`` (a
    ``repro_torch.scenarios.arrivals`` process instance or its config dict)
    for jittered, Poisson, bursty or diurnal traffic. The processes draw
    from the stream's generator as the JAX package's do, so a workload
    definition gives the same arrival times and prompts in both engines.
    """

    clock: Callable[[], float]
    streams: dict[str, dict] = field(default_factory=dict)
    pending: list[ServeRequest] = field(default_factory=list)
    _rid: itertools.count = field(default_factory=itertools.count)

    def add_stream(self, model: str, fps: float, batch: int, seq: int,
                   vocab: int, deadline_frac: float = 1.0,
                   depends_on: Optional[str] = None,
                   trigger_prob: float = 1.0,
                   arrival=None) -> None:
        # crc32, not hash(): string hashing is salted per process and would
        # make stream contents differ run to run
        rng = np.random.default_rng(zlib.crc32(model.encode()) & 0xFFFF)
        proc = None
        next_t = 0.0
        if arrival is not None and depends_on is None:
            # a copy per stream: processes carry per-stream state (MMPP
            # clocks), so streams must never share one instance
            proc = (arrival_from_config(arrival) if isinstance(arrival, dict)
                    else copy.copy(arrival))
            next_t = proc.start(len(self.streams), 1.0 / fps, rng)
        self.streams[model] = dict(
            fps=fps, batch=batch, seq=seq, vocab=vocab, next_t=next_t,
            deadline=deadline_frac / fps, depends_on=depends_on,
            trigger_prob=trigger_prob, rng=rng, arrival=proc)

    def poll(self, now: float) -> list[ServeRequest]:
        """Emit any frames whose arrival time elapsed (head streams); a
        stream whose process returns None emits no more."""
        out = []
        for name, st in self.streams.items():
            if st["depends_on"] is not None:
                continue
            while st["next_t"] is not None and st["next_t"] <= now:
                t = st["next_t"]
                out.append(self._make(name, st, t))
                if st["arrival"] is None:
                    st["next_t"] = t + 1.0 / st["fps"]
                else:
                    st["next_t"] = st["arrival"].next_after(
                        t, 1.0 / st["fps"], st["rng"])
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


class TraceReplayQueue(RequestQueue):
    """Replays the head arrivals of a recorded trace
    (``repro_torch.scenarios.trace.Trace``, the JAX package's format).

    Each recorded arrival time becomes one request for the matching
    registered stream; models absent from the stream registry are ignored,
    so a trace can be replayed against a subset deployment. Dependent
    streams stay live: cascade triggering remains the queue's own seeded
    draw.
    """

    def __init__(self, clock: Callable[[], float], trace) -> None:
        super().__init__(clock=clock)
        self._times: dict[str, deque] = {
            name: deque(ts) for name, ts in trace.arrivals_by_model().items()
        }

    def poll(self, now: float) -> list[ServeRequest]:
        out = []
        for name, st in self.streams.items():
            if st["depends_on"] is not None:
                continue
            q = self._times.get(name)
            while q and q[0] <= now:
                out.append(self._make(name, st, q.popleft()))
        self.pending.extend(out)
        return out


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


def _clock_anchor(now: Callable[[], float]) -> list:
    """[engine seconds, Unix ns] read back to back: of three tries the pair
    whose two reads of ``now`` lie closest, at their midpoint."""
    best = None
    for _ in range(3):
        a = now()
        unix = time.time_ns()
        b = now()
        if best is None or b - a < best[0]:
            best = (b - a, [(a + b) / 2, unix])
    return best[1]


def _sync(device: torch.device) -> None:
    """Wait for the work this thread enqueued on ``device``: its current
    stream, not the streams of engines on other threads."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


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
                 seed: int = 0, obs=None, obs_node=None):
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
        self._tracer = getattr(obs, "tracer", None)
        self._obs_node = obs_node
        #: this run's open job spans by request id, and its spans' tags
        self._job_span: dict[int, int] = {}
        self._tags: dict[str, Any] = {}

    @property
    def lat_samples(self) -> dict[str, list[float]]:
        """Wall seconds of every timed call served so far, one per call, by
        the model (or supernet variant) that ran."""
        return self._lat_samples

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
            if self._tracer is not None:
                self._close_job(best, now, "dropped")

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

    # ------------------------------------------------------------- tracing
    def _open_jobs(self, reqs: list[ServeRequest], seen: float,
                   parent: Optional[ServeRequest] = None) -> None:
        """A job span for each request the engine sees first at ``seen``.
        It opens at the arrival, or at ``seen`` where the queue hands a
        cascade frame over before its arrival (the port's queue stamps it
        with its parent's modelled completion)."""
        extra = {} if parent is None else {"parent": self._uid(parent)}
        for r in reqs:
            self._job_span[r.rid] = self._tracer.open(
                "job", min(r.arrival, seen), uid=self._uid(r),
                model=r.model, origin=r.arrival, deadline=r.deadline,
                **extra, **self._tags)

    def _uid(self, req: ServeRequest) -> str:
        return (f"r{req.rid}" if self._obs_node is None
                else f"n{self._obs_node}:r{req.rid}")

    def _close_job(self, req: ServeRequest, t: float, outcome: str,
                   **attrs) -> None:
        self._tracer.close(self._job_span.pop(req.rid), t, outcome=outcome,
                           **attrs)

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
        tr = self._tracer
        if tr is not None:
            anchor = _clock_anchor(now_fn)
            run_sid = tr.open("engine.run", 0.0, node=self._obs_node)
            self._tags = {"run": run_sid, "node": self._obs_node}
            self._job_span = {}
            # the open engine.wait and engine.after spans' starts
            wait_t0 = after_t0 = None

        while True:
            now = now_fn()
            if tr is not None and after_t0 is not None:
                tr.span("engine.after", after_t0, now, **self._tags)
                after_t0 = None
            if now >= duration_s:
                break
            polled = queue.poll(now)
            if tr is not None:
                self._open_jobs(polled, now)
            self._waiting.extend(polled)
            self._waiting = [r for r in self._waiting if not r.done]
            # hygiene: a frame still waiting `stale_periods` past its
            # deadline-equivalent period is abandoned (counts violated)
            for r in self._waiting:
                period = r.deadline - r.arrival
                if now > r.deadline + self.stale_periods * period:
                    r.done, r.dropped = True, True
                    self.aborted += 1
                    self._finish_stats(r)
                    if tr is not None:
                        self._close_job(r, now, "aborted")
            self._waiting = [r for r in self._waiting if not r.done]
            if self.frame_drop:
                self._try_drop(now)
            ready = [r for r in self._waiting if not r.done]
            idle = [a for a in self.accs if a.busy_until <= now]
            if not ready or not idle:
                if tr is not None and wait_t0 is None:
                    wait_t0 = now
                nxt = min([a.busy_until for a in self.accs
                           if a.busy_until > now] + [now + 1e-3])
                time.sleep(max(min(nxt - now, 1e-3), 1e-5))
                if now >= next_window:
                    wux = uxcost(self.window_stats)
                    window = self.window_stats.per_model.values()
                    frames = sum(st.frames for st in window)
                    if tr is not None:
                        tr.event("engine.window", now, uxcost=float(wux),
                                 alpha=self.params.alpha,
                                 beta=self.params.beta, frames=frames,
                                 violated=sum(st.violated for st in window),
                                 **self._tags)
                    if self.adaptivity and frames:
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
            handle = self.models[run_as]
            tok = req.tokens
            if tr is not None:
                if wait_t0 is not None:
                    tr.span("engine.wait", wait_t0, now, **self._tags)
                    wait_t0 = None
                t_disp = t_ret = now_fn()
                tr.span("engine.decide", now, t_disp,
                        evals=len(ready) * len(idle), ready=len(ready),
                        idle=len(idle), **self._tags)
            if tok.shape[1] > 0:
                dev = self.devices[run_as]
                t0 = time.perf_counter()
                out = handle.fn(handle.params, torch.from_numpy(tok).to(dev))
                if tr is not None:
                    t_ret = now_fn()
                _sync(dev)
                wall = time.perf_counter() - t0
                req.result = out
            else:
                wall = 0.0
            if tr is not None:
                t_handed = now_fn()
                tr.span("engine.enqueue", t_disp, t_ret, **self._tags)
                tr.span("engine.sync", t_ret, t_handed, **self._tags)
            # straggler mitigation: re-dispatch if way past expectation
            expect = self.lat_table[(run_as, acc.name)]
            samples = self._lat_samples.setdefault(run_as, [])
            samples.append(wall)
            redispatched = False
            if wall > self.straggler_factor * expect and len(samples) > 4:
                alt = min((a for a in self.accs if a is not acc),
                          key=lambda a: self.lat_table[(run_as, a.name)],
                          default=None)
                if alt is not None:
                    self.redispatched += 1
                    acc = alt
                    redispatched = True
            # virtual time accounting (speed factor models slice size)
            vlat = max(wall, self.lat_table[(run_as, acc.name)])
            done_at = now + vlat
            acc.busy_until = done_at
            acc.last_model = run_as
            req.energy = vlat * acc.power
            req.done = True
            req.completion = done_at
            self._finish_stats(req)
            children = queue.trigger_dependents(req.model, done_at)
            if tr is not None:
                self._close_job(req, t_handed, "done", variant=run_as,
                                slice=acc.name, completion=done_at,
                                redispatched=redispatched,
                                segs=[[t_disp, t_handed]])
                self._open_jobs(children, t_handed, parent=req)
                after_t0 = t_handed
            self._waiting.extend(children)

        if tr is not None:
            if wait_t0 is not None:
                tr.span("engine.wait", wait_t0, now, **self._tags)
            for sid in self._job_span.values():
                tr.close(sid, now, outcome="unfinished")
            self._job_span = {}
            tr.close(run_sid, now, clock=[anchor, _clock_anchor(now_fn)])
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
