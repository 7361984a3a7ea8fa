"""Discrete-event simulator for RTMM workloads on multi-accelerator systems.

The engine owns: frame arrivals (pluggable arrival processes — strict
periodic per Table-3 FPS by default, or jittered / Poisson / bursty /
diurnal streams from ``repro_torch.scenarios.arrivals``), control-dependency
triggering (cascaded pipelines), dynamic-path sampling (SkipNet skips /
RAPID-RL early exits), per-layer dispatch onto accelerators, deadline & energy
accounting (UXCost windows), and stale-job hygiene. Schedulers (DREAM and the
baselines) plug in through the `SchedulerBase` interface and only make
(job, accelerator, n_layers) decisions.

Workload dynamicity beyond path sampling comes from two hooks:

  * a ``phase_script`` (``repro_torch.scenarios.phases.PhaseScript``) applies timed
    scenario mutations — FPS retargeting, cascade-probability shifts, models
    joining and leaving — as first-class PHASE events;
  * ``record=True`` captures the run's external stochastic input (head
    arrivals + phase actions) as a ``repro_torch.scenarios.trace.Trace``, and
    ``replay=<trace>`` feeds a recorded trace back in.  Arrival randomness
    lives on a dedicated generator, so a replayed run with the same ``seed``
    reproduces the live run exactly (same jobs, dispatches, UXCost).

Determinism: `numpy.random.Generator`s seeded at construction drive every
stochastic draw; the event heap is tie-broken with a monotone sequence number.
Core imports nothing from ``repro_torch.scenarios`` at module scope — arrival
processes and phase actions are duck-typed, materialized lazily.
"""
from __future__ import annotations

import heapq
import itertools
import warnings
from bisect import insort
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np

from .costmodel import CostTable, E_DRAM, build_tables, effective_deadline
from .engine import EngineConfig
from .types import Accelerator, ModelGraph, ModelSpec, Scenario, SYSTEMS
from .uxcost import (WindowStats, uxcost, overall_dlv_rate,
                     overall_norm_energy, overall_pipeline_latency)

ARRIVAL, DONE, WINDOW, PHASE, INJECT = 0, 1, 2, 3, 4

#: profiler keys per event kind (indexed by the constants above)
_EVENT_NAMES = ("arrival", "done", "window", "phase", "inject")

#: arrival-process rng stream id, kept distinct from the path/cascade stream
#: so trace replay (which consumes no arrival randomness) stays bit-exact.
_ARRIVAL_STREAM = 0xA221

#: token-count rng stream id (autoregressive generation lengths), distinct
#: from both the path/cascade stream and the arrival stream: legacy
#: (genai-free) populations never touch it, and replay feeds recorded draws
#: back without consuming it — both directions stay bit-exact.
_TOKEN_STREAM = 0x70C3

#: EWMA smoothing factor for the per-model generation-length predictor
#: (Sparse-DySta-style: completed generations feed the estimate).
TOKEN_EWMA_ALPHA = 0.5

#: Python-list mirrors of a CostTable's per-accelerator rows, keyed by
#: ``id(table.lat)`` with the array pinned so the id cannot be recycled.
#: ``.tolist()`` round-trips float64 exactly; the dispatch hot path sums a
#: handful of these per event, where scalar list indexing beats a numpy
#: fancy-index + reduction.  Wholesale-cleared when oversized.
_ROW_CACHE: dict[int, tuple] = {}
_ROW_CACHE_MAX = 4096


def _py_rows(table: CostTable) -> tuple:
    key = id(table.lat)
    hit = _ROW_CACHE.get(key)
    if hit is not None and hit[0] is table.lat:
        return hit
    if len(_ROW_CACHE) >= _ROW_CACHE_MAX:
        _ROW_CACHE.clear()
    entry = (table.lat, table.lat.tolist(), table.en.tolist(),
             table.in_bytes.tolist(), table.out_bytes.tolist())
    _ROW_CACHE[key] = entry
    return entry


def _genai_sched_cum(table: CostTable, path: np.ndarray, prefill_len: int,
                     decode_len: int, pred_tokens: float) -> np.ndarray:
    """Scheduler-visible remaining-time profile of an autoregressive job.

    ``out[pos]`` is the *predicted* mean remaining latency at path position
    ``pos``: the rest of the current phase (prefill tail, or the current
    decode step's tail) plus ``pred_tokens`` worth of further decode steps —
    the length predictor's estimate, not the sampled truth.  All three
    scheduler arms (scalar fast path, numpy reference, SoA batch) read this
    one precomputed array, so they agree bit-for-bit by construction.
    """
    lm = table.lat_mean
    pl, dl = prefill_len, decode_len
    decode_idx = path[pl: pl + dl]
    step_s = float(lm[decode_idx].sum())
    step_cum = [float(lm[decode_idx[w:]].sum()) for w in range(dl)]
    out = np.zeros(len(path) + 1)
    for pos in range(len(path)):
        if pos < pl:
            out[pos] = (float(lm[path[pos: pl]].sum())
                        + pred_tokens * step_s)
        else:
            w = (pos - pl) % dl
            done = (pos - pl) // dl
            out[pos] = (step_cum[w]
                        + max(pred_tokens - done - 1.0, 0.0) * step_s)
    return out


class JobTable:
    """Structure-of-arrays mirror of the live job set (the slab core's
    substrate).  One row per live :class:`Job`, appended in jid order and
    tombstoned on finish, so ``alive`` rows always enumerate the job dict's
    iteration order.  Columns hold exactly the float64 values the scalar
    hot paths read off the Job object — ``togo_mean``/``togo_min`` are the
    sequential suffix-cumsum reads (``Job.togo()``/``min_togo()``) while
    ``togo_sched`` is the *pairwise* ``togo_seconds`` sum the scheduler
    scores with; the two differ in the last bits and must never be merged
    (see docs/performance.md).  ``lat_n``/``en_n`` cache the next layer's
    per-accelerator cost rows so a batched MapScore pass is two fancy
    gathers instead of a Python loop.

    Maintenance is eager at every point ``pos``/``deadline``/``path`` can
    move (create, block completion, variant switch, inject anchor, finish,
    purge); compaction runs when tombstones outnumber live rows, preserving
    relative (jid) order.
    """

    __slots__ = ("cap", "n", "dead", "n_accs", "row_of", "jid", "arrival",
                 "deadline", "t_cmpl", "energy", "pos", "togo_mean",
                 "togo_min", "togo_sched", "lat_sum_n", "en_sum_n", "in_b_n",
                 "lat_mean_n", "base_id", "is_tail", "alive", "cost_stale",
                 "lat_n", "en_n")

    _F8 = ("arrival", "deadline", "t_cmpl", "energy", "togo_mean",
           "togo_min", "togo_sched", "lat_sum_n", "en_sum_n", "in_b_n",
           "lat_mean_n")

    def __init__(self, n_accs: int, cap: int = 64):
        self.cap = cap
        self.n = 0              # rows in use (live + tombstones)
        self.dead = 0
        self.n_accs = n_accs
        self.row_of: dict[int, int] = {}
        self.jid = np.zeros(cap, np.int64)
        self.pos = np.zeros(cap, np.int64)
        self.base_id = np.zeros(cap, np.int64)
        self.is_tail = np.zeros(cap, bool)
        self.alive = np.zeros(cap, bool)
        #: next-layer cost columns below are refreshed lazily (the batch
        #: scheduler arm is their only reader): True = row's lat_sum_n /
        #: en_sum_n / in_b_n / lat_mean_n / lat_n / en_n lag job.pos
        self.cost_stale = np.zeros(cap, bool)
        for name in self._F8:
            setattr(self, name, np.zeros(cap))
        self.lat_n = np.zeros((cap, n_accs))
        self.en_n = np.zeros((cap, n_accs))

    def grow(self) -> None:
        self.cap *= 2
        for name in ("jid", "pos", "base_id", "is_tail", "alive",
                     "cost_stale", *self._F8, "lat_n", "en_n"):
            old = getattr(self, name)
            new = np.zeros((self.cap,) + old.shape[1:], old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def live_rows(self) -> np.ndarray:
        """Row indices of live jobs, ascending — i.e. jid/dict order."""
        return np.flatnonzero(self.alive[: self.n])

    def compact(self) -> None:
        keep = self.live_rows()
        m = len(keep)
        for name in ("jid", "pos", "base_id", "is_tail", "cost_stale",
                     *self._F8, "lat_n", "en_n"):
            arr = getattr(self, name)
            arr[:m] = arr[keep]
        self.alive[:m] = True
        self.alive[m: self.n] = False
        self.n = m
        self.dead = 0
        self.row_of = {int(j): i for i, j in enumerate(self.jid[:m])}


@dataclass
class Job:
    """One inference request (a frame of one model) — the paper's 'task'."""

    jid: int
    model_idx: int              # index into scenario.models
    base_name: str              # stats key (Supernet variants share it)
    graph_name: str             # concrete graph (may be a variant)
    table: CostTable
    path: np.ndarray            # sampled layer indices
    cum_mean: np.ndarray        # suffix sums of lat_mean over path (ToGo)
    cum_min: np.ndarray         # suffix sums of lat_min over path (min_to_go)
    path_list: list             # path.tolist() — dispatch-loop fast view
    arrival: float
    deadline: float
    #: pipeline origin: the head frame's arrival time, inherited down the
    #: cascade (and across nodes, wire time included) — tail completions
    #: record ``t - origin`` as head-to-tail pipeline latency
    origin: float = 0.0
    pos: int = 0
    t_cmpl: float = 0.0         # last layer completion (Alg.1 T_cmpl)
    running: bool = False
    done: bool = False
    dropped: bool = False
    energy_used: float = 0.0
    worst_energy: float = 0.0
    is_tail: bool = True        # no dependents (frame-drop condition 3)
    variant_locked: bool = False
    # ---- autoregressive (genai) jobs only; zero/None on classic frames.
    # ``sched_cum`` replaces the true-path ToGo in every scheduler arm: the
    # scheduler scores against the length *predictor*'s estimate, never the
    # sampled token count (which the engine alone knows).
    tokens_total: int = 0       # sampled generation length (tokens)
    prefill_len: int = 0        # path positions [0, prefill_len) = prompt
    decode_len: int = 0         # layers per decode step (token boundary)
    pred_tokens: float = 0.0    # predictor estimate, frozen at creation
    sched_cum: Optional[np.ndarray] = None  # predicted ToGo by position
    sched_list: Optional[list] = None       # .tolist() fast view

    @property
    def n_layers(self) -> int:
        return len(self.path)

    @property
    def finished_exec(self) -> bool:
        return self.pos >= len(self.path)

    def togo(self) -> float:
        return float(self.cum_mean[self.pos]) if self.pos < self.n_layers else 0.0

    def min_togo(self) -> float:
        return float(self.cum_min[self.pos]) if self.pos < self.n_layers else 0.0

    def slack(self, t: float) -> float:
        return self.deadline - t


@dataclass
class AccState:
    idx: int
    acc: Accelerator
    busy: bool = False
    busy_until: float = 0.0
    cur_job: Optional[Job] = None
    prev_base: Optional[str] = None   # base model name of last executed job
    prev_base_id: int = -1            # its interned id (SoA batch arm key)
    prev_jid: int = -1                # its jid (token-preemption detection)
    prev_out_bytes: float = 0.0       # its last layer's activation bytes
    busy_time: float = 0.0            # cumulative, for utilization reporting


@dataclass
class Dispatch:
    job: Job
    acc_idx: int
    n_layers: int = 1
    reserve_worst: bool = False  # static scheduling: hold the slot for the
    # worst-case duration even if the sampled path finishes earlier


class SchedulerBase:
    """Scheduler plug-in interface."""

    name = "base"

    def on_job_created(self, sim: "Simulator", job: Job) -> None:  # noqa: D401
        pass

    def on_window(self, sim: "Simulator", stats: WindowStats, uxc: float) -> None:
        pass

    def schedule(self, sim: "Simulator", t: float) -> Optional[Dispatch]:
        raise NotImplementedError


@dataclass
class SimResult:
    scenario: str
    system: str
    scheduler: str
    duration_s: float
    stats: WindowStats
    uxcost: float
    dlv_rate: float
    norm_energy: float
    frames: int
    drops: int
    aborts: int
    variant_counts: dict[str, int]
    windows: list[tuple[float, float, float, float]]  # (t, uxcost, alpha, beta)
    acc_utilization: list[float]
    trace: Optional[object] = None      # recorded Trace when record=True
    pipeline_latency_s: float = 0.0     # mean head-to-tail latency (s)

    def summary(self) -> str:
        return (f"{self.scenario:>14s} {self.system:>10s} {self.scheduler:>16s} "
                f"UXCost={self.uxcost:8.4f} DLV={self.dlv_rate:6.3f} "
                f"E={self.norm_energy:6.3f} frames={self.frames} drops={self.drops}")


class Simulator:
    #: Structure-of-arrays slab-stepping toggle.  When on, the engine
    #: mirrors every live job into a flat :class:`JobTable` and
    #: ``step_until`` advances in *time slabs*: between the boundaries an
    #: external observer can see (the fleet clock's interleave points,
    #: window/phase/arrival events), block completions bypass the global
    #: event heap through a slab-local done lane and job state lands in
    #: flat arrays.  Bit-identical to the scalar per-event oracle by
    #: construction (tests/test_vectorized_equiv.py flips this flag).
    soa_slab = True

    def __init__(
        self,
        scenario: Scenario,
        system: str | tuple[Accelerator, ...],
        scheduler: SchedulerBase,
        duration_s: float = 8.0,
        seed: int = 0,
        window_s: float = 0.5,
        stale_periods: float = 2.0,
        cs_latency_s: float = 0.0,
        phase_script=None,
        record: bool = False,
        replay=None,
        genai_predictor: bool = True,
        engine: "EngineConfig | str | None" = None,
        obs=None,
        obs_node=None,
        soa_slab: "bool | None" = None,
    ):
        self.scenario = scenario
        self.system_name = system if isinstance(system, str) else "custom"
        self.accs_spec = SYSTEMS[system] if isinstance(system, str) else system
        self.scheduler = scheduler
        if soa_slab is not None:
            # legacy flag shim: pre-EngineConfig callers toggled the slab
            # arm directly; fold it into the config so one mechanism rules
            warnings.warn(
                "Simulator(soa_slab=...) is deprecated; pass "
                "engine=EngineConfig(..., soa_slab=...) instead",
                DeprecationWarning, stacklevel=2)
            cfg = EngineConfig.make(engine) or EngineConfig()
            engine = replace(cfg, soa_slab=soa_slab)
        self.engine = EngineConfig.make(engine)
        if self.engine is not None:
            # instance-level pins; engine=None keeps class-attr behavior
            self.engine.apply_simulator(self)
        self.duration_s = duration_s
        self.window_s = window_s
        self.stale_periods = stale_periods
        self.cs_latency_s = cs_latency_s
        self.rng = np.random.default_rng(seed)
        self.arrival_rng = np.random.default_rng([seed, _ARRIVAL_STREAM])
        self.token_rng = np.random.default_rng([seed, _TOKEN_STREAM])
        #: length predictor toggle — False runs the blind ablation (every
        #: autoregressive job priced at its variant's max_new_tokens cap)
        self.genai_predictor = genai_predictor
        #: per-model EWMA of completed generation lengths
        self._tok_ewma: dict[str, float] = {}

        #: live pipeline specs — phase scripts mutate these, not the
        #: (immutable) scenario the simulator was constructed from
        self.specs: list[ModelSpec] = list(scenario.models)
        self.active: list[bool] = [True] * len(self.specs)
        #: name -> spec index and parent name -> dependent spec indices,
        #: maintained on join (specs are append-only and names unique) so
        #: the per-event lookups need no linear rescan of the spec list
        self._name_idx: dict[str, int] = {}
        self._deps_idx: dict[str, list[int]] = {}
        for i, s in enumerate(self.specs):
            self._name_idx.setdefault(s.model.name, i)   # first match wins
            if s.depends_on is not None:
                self._deps_idx.setdefault(s.depends_on, []).append(i)
        #: lazy (stale-threshold, jid) min-heap guarding _abort_stale: the
        #: scan over ready jobs only runs when some pushed threshold is
        #: actually due.  Entries are conservative — jobs re-push on
        #: deadline/period changes and finished jobs' entries just expire —
        #: so the guard never skips a scan the threshold scan would run.
        self._stale_heap: list[tuple[float, int]] = []

        self.models: dict[str, ModelGraph] = {
            s.model.name: s.model for s in self.specs
        }
        self.tables: dict[str, CostTable] = build_tables(self.models, self.accs_spec)
        self.graphs: dict[str, ModelGraph] = dict(self.models)
        for m in self.models.values():
            for v in m.variants:
                self.graphs[v.name] = v

        #: system-dependent per-model deadlines (Planaria convention)
        self.deadlines: dict[str, float] = {
            s.model.name: effective_deadline(s.period_s,
                                             self.tables[s.model.name],
                                             s.deadline_s,
                                             graph=s.model)
            for s in self.specs
        }
        self.accs = [AccState(i, a) for i, a in enumerate(self.accs_spec)]
        #: SoA job mirror (None when the scalar oracle path is active)
        self.soa: Optional[JobTable] = (
            JobTable(len(self.accs)) if self.soa_slab else None)
        #: base-name intern table shared with the scheduler batch arm
        self._base_ids: dict[str, int] = {}
        #: slab done lane: while a slab is open, _dispatch routes DONE
        #: events here (sorted (t, seq, acc_idx) triples) instead of the
        #: global heap; flushed back on slab exit so peek_t() is unchanged
        self._slab_sink: Optional[list] = None
        self._slab_dones: list[tuple[float, int, int]] = []
        self.events: list[tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self.t = 0.0
        self.jobs: dict[int, Job] = {}
        self.ready: dict[int, Job] = {}
        self._jid = itertools.count()

        self.global_stats = WindowStats()
        self.window_stats = WindowStats()
        #: running (frames, violated) totals over global_stats — updated at
        #: each window merge so fleet DLV telemetry reads O(1) counters
        #: instead of walking per_model every node advance
        self.merged_frames = 0
        self.merged_violated = 0
        self.windows: list[tuple[float, float, float, float]] = []
        self.variant_counts: dict[str, int] = {}
        # stream-level variant pins (SLO graceful degradation): model name ->
        # variant graph every future job of that model is created on
        self._variant_override: dict[str, ModelGraph] = {}
        self.drops = 0
        self.aborts = 0
        self.frames = 0
        # frame-drop condition 4: outcome history (True == dropped) per model
        self.drop_history: dict[str, list[bool]] = {
            s.model.name: [] for s in self.specs
        }
        self.drop_window = 10
        self.max_drops_per_window = 2

        if replay is not None and phase_script is not None:
            raise ValueError("replay traces carry their own phase events; "
                             "pass either phase_script or replay, not both")
        self.phase_script = phase_script
        self.replay = replay
        self._replay_queues: dict[str, deque] = {}
        self._replay_tokens: dict[str, deque] = {}
        if replay is not None:
            rs = replay.meta.get("scenario")
            if rs is not None and rs != scenario.name:
                raise ValueError(f"trace was recorded for scenario {rs!r}, "
                                 f"not {scenario.name!r}")
            self._replay_queues = {
                name: deque(ts)
                for name, ts in replay.arrivals_by_model().items()
            }
            self._replay_tokens = {
                name: deque(ns)
                for name, ns in replay.tokens_by_model().items()
            }
            # the predictor setting is part of the recorded run's identity
            self.genai_predictor = bool(
                replay.meta.get("genai_predictor", True))
        self.recorder = None
        self.trace = None
        if record:
            from ..scenarios.trace import TraceRecorder
            meta = {
                "scenario": scenario.name, "system": self.system_name,
                "seed": seed, "duration_s": duration_s,
                "window_s": window_s,
            }
            if not self.genai_predictor:
                # non-default only, so legacy traces keep identical headers
                meta["genai_predictor"] = False
            self.recorder = TraceRecorder(meta)
        #: cross-simulator cascade surface (used by the fleet layer when a
        #: pipeline is split across nodes): completions of models named here
        #: are queued on ``pending_completions`` for an external driver to
        #: drain and forward; both stay empty in single-node runs, so the
        #: engine's behavior and RNG consumption are untouched
        self.export_completions: set[str] = set()
        #: (model name, completion time, pipeline origin, job uid) — uid is
        #: the completing job's span uid when tracing, else None; the fleet
        #: threads it through inject_arrival so cross-node child spans link
        #: back to their parent for critical-path extraction
        self.pending_completions: list[
            tuple[str, float, float, Optional[str]]] = []
        self._arrival_procs = [self._materialize_arrival(s.arrival)
                               for s in self.specs]
        #: per-stream time origin: arrival processes run in stream-local
        #: time (0 at stream start), so a mid-run join at t anchors its
        #: process — including any internal MMPP/diurnal clock — at t
        self._arrival_origin = [0.0] * len(self.specs)
        self._started = False

        # ------------------------------------------------ observability
        # ``obs`` is a duck-typed bundle (repro_torch.obs.Obs): tracer / metrics
        # / profiler attributes, each possibly None.  Core never imports
        # repro_torch.obs; every hook below guards with ``is not None``, so the
        # disabled path costs one attribute check and consumes no RNG —
        # traced runs stay bit-identical to bare ones.  ``obs_node`` tags
        # spans/metrics with the hosting fleet node id.
        self.obs = obs
        self._tracer = getattr(obs, "tracer", None)
        self._metrics = getattr(obs, "metrics", None)
        self._profiler = getattr(obs, "profiler", None)
        self._obs_node = obs_node
        self._node_lbl = "-" if obs_node is None else str(obs_node)
        self._span_of: dict[int, int] = {}     # jid -> open job span id
        self._segs_of: dict[int, list] = {}    # jid -> [(t0, t1)] exec blocks
        self._uid_of: dict[int, str] = {}      # jid -> cross-node job uid
        if self._metrics is not None:
            self._m_frames = self._metrics.counter(
                "sim_frames_total", "completed frames (incl. drops)",
                ("node", "model"))
            self._m_violations = self._metrics.counter(
                "sim_violations_total", "deadline-violated frames",
                ("node", "model"))
            self._m_drops = self._metrics.counter(
                "sim_drops_total", "dropped/aborted frames",
                ("node", "model"))
            self._m_energy = self._metrics.counter(
                "sim_energy_joules_total", "energy charged to frames",
                ("node",))
            self._m_latency = self._metrics.histogram(
                "sim_frame_latency_seconds",
                "frame arrival -> completion latency", ("node",))

    @staticmethod
    def _materialize_arrival(arrival):
        """None -> legacy periodic; dict -> from_config; else duck-typed.
        Instances are shallow-copied: a process carries per-stream state
        (MMPP clocks), so streams must never share one."""
        import copy
        from ..scenarios.arrivals import Periodic, arrival_from_config
        if arrival is None:
            return Periodic()
        if isinstance(arrival, dict):
            return arrival_from_config(arrival)
        return copy.copy(arrival)

    # --------------------------------------------------------- live specs
    def _index_of(self, name: str) -> int:
        idx = self._name_idx.get(name)
        if idx is None:
            raise KeyError(name)
        return idx

    def _dependents_of(self, name: str) -> list[int]:
        # _deps_idx preserves spec append order, so the filtered list is
        # element-identical to the original enumerate() scan
        return [i for i in self._deps_idx.get(name, ())
                if self.active[i]]

    def _is_chain_tail(self, idx: int) -> bool:
        name = self.specs[idx].model.name
        if name in self.export_completions:
            return False                # has remote (cross-node) dependents
        return not any(self.active[i]
                       for i in self._deps_idx.get(name, ()))

    # ------------------------------------------------------------- events
    def _push(self, t: float, kind: int, arg: object) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, arg))

    def _schedule_head_arrivals(self) -> None:
        for i, spec in enumerate(self.specs):
            if spec.depends_on is None:
                self._schedule_stream_arrival(i, after_t=None)

    def _push_phase_events(self) -> None:
        if self.replay is not None:
            if self.replay.phases:
                from ..scenarios.phases import PhaseAction
                for t, cfg in self.replay.phases:
                    self._push(t, PHASE, PhaseAction.from_config(cfg))
        elif self.phase_script is not None:
            for t, action in self.phase_script:
                self._push(t, PHASE, action)

    def _schedule_stream_arrival(self, idx: int,
                                 after_t: Optional[float]) -> None:
        """Queue stream ``idx``'s next head arrival.  ``after_t`` is the
        absolute time of the arrival just processed (None = stream start).
        Replay pops recorded times; live runs ask the arrival process in
        stream-local time and shift by the stream's origin."""
        spec = self.specs[idx]
        if self.replay is not None:
            q = self._replay_queues.get(spec.model.name)
            if q:
                self._push(q.popleft(), ARRIVAL, idx)
            return
        proc = self._arrival_procs[idx]
        origin = self._arrival_origin[idx]
        if after_t is None:
            nxt = proc.start(idx, spec.period_s, self.arrival_rng)
        else:
            nxt = proc.next_after(after_t - origin, spec.period_s,
                                  self.arrival_rng)
        if nxt is not None:
            self._push(origin + nxt, ARRIVAL, idx)

    # ------------------------------------------------------ phase actions
    def _apply_phase(self, action, t: float) -> None:
        kind, payload = action.kind, action.payload
        if kind == "set_fps":
            self._set_fps(self._index_of(payload["model"]), payload["fps"])
        elif kind == "scale_fps":
            targets = payload.get("models")
            for i, s in enumerate(self.specs):
                if targets is None or s.model.name in targets:
                    self._set_fps(i, s.fps * payload["factor"])
        elif kind == "set_trigger_prob":
            prob = payload["prob"]
            if not 0.0 <= prob <= 1.0:   # traces may be hand-edited
                raise ValueError(f"set_trigger_prob: {prob} outside [0, 1]")
            i = self._index_of(payload["model"])
            self.specs[i] = replace(self.specs[i], trigger_prob=prob)
        elif kind == "leave":
            self.active[self._index_of(payload["model"])] = False
        elif kind == "join":
            from ..scenarios.phases import join_entry
            self._join_spec(join_entry(action).to_spec(), t)
        else:
            raise ValueError(f"unknown phase action kind {kind!r}")
        if self.recorder is not None:
            self.recorder.phase(t, action.to_config())

    def _set_fps(self, idx: int, fps: float) -> None:
        if not (np.isfinite(fps) and fps > 0):
            # a non-positive period would schedule arrivals backwards and
            # keep the event loop below duration_s forever
            raise ValueError(f"set_fps: fps must be positive, got {fps}")
        spec = replace(self.specs[idx], fps=float(fps))
        self.specs[idx] = spec
        name = spec.model.name
        # the in-flight arrival event still uses the old period; the stream
        # converges to the new rate from the next inter-arrival onward
        self.deadlines[name] = effective_deadline(
            spec.period_s, self.tables[name], spec.deadline_s,
            graph=spec.model)
        # the stale-abort threshold of queued head jobs moves with the
        # period — re-arm their lazy-heap entries so a shrunk grace window
        # still fires on time (old entries expire harmlessly)
        for j in self.ready.values():
            if j.model_idx == idx and j.pos == 0:
                heapq.heappush(
                    self._stale_heap,
                    (j.deadline + self.stale_periods * spec.period_s, j.jid))

    def _join_spec(self, spec: ModelSpec, t: float) -> None:
        name = spec.model.name
        if name in self.models:
            raise ValueError(f"join: model {name!r} already in the scenario "
                             "(leave has no rejoin; use a fresh name)")
        # joins arrive from phase scripts and hand-editable replay traces,
        # which bypass ScenarioBuilder.validate — re-check the hazards here
        # (a non-positive period would schedule arrivals backwards and keep
        # the event loop below duration_s forever)
        if not (np.isfinite(spec.fps) and spec.fps > 0):
            raise ValueError(f"join: fps must be positive, got {spec.fps}")
        if not 0.0 <= spec.trigger_prob <= 1.0:
            raise ValueError(f"join: trigger_prob {spec.trigger_prob} "
                             "outside [0, 1]")
        if spec.depends_on is not None and spec.depends_on not in self.models:
            raise ValueError(f"join: {name!r} depends on {spec.depends_on!r},"
                             " which is not in the scenario")
        self.models[name] = spec.model
        self.tables.update(build_tables({name: spec.model}, self.accs_spec))
        self.graphs[name] = spec.model
        for v in spec.model.variants:
            self.graphs[v.name] = v
        self.deadlines[name] = effective_deadline(
            spec.period_s, self.tables[name], spec.deadline_s,
            graph=spec.model)
        self.drop_history[name] = []
        idx = len(self.specs)
        self.specs.append(spec)
        self.active.append(True)
        self._name_idx.setdefault(name, idx)     # first match wins
        if spec.depends_on is not None:
            self._deps_idx.setdefault(spec.depends_on, []).append(idx)
        self._arrival_procs.append(self._materialize_arrival(spec.arrival))
        self._arrival_origin.append(t)
        if spec.depends_on is None:
            self._schedule_stream_arrival(idx, after_t=None)

    # --------------------------------------------- external-driver surface
    def join_model(self, spec: ModelSpec, t: float) -> None:
        """Add a pipeline stage at time ``t`` (fleet routers place streams
        through this; equivalent to a ``join`` phase action)."""
        self._join_spec(spec, t)

    def leave_model(self, name: str, t: float) -> None:
        """Stop a model's arrivals and cascade triggers at time ``t``.
        Already-created jobs still execute and count toward stats."""
        del t  # takes effect immediately; kept for call-site symmetry
        self.active[self._index_of(name)] = False

    def purge_model(self, name: str) -> int:
        """Discard every not-yet-running job of ``name`` without counting
        frames or violations — the load-release half of a stream
        *departure*: the stream's user walked away, so its queued frames
        stop mattering and must not count as violations or drops.  Jobs
        currently executing finish normally (an accelerator cannot abandon
        a launched layer) and still count.  Energy is the exception: a job
        evicted *between* dispatch blocks (queued with ``pos > 0``) already
        burned real joules, which the stream's final UXCost entry must keep
        — energy spent is never un-spent, mirroring how migration transfer
        energy is charged.  Returns the number of jobs purged."""
        idx = self._index_of(name)
        gone = [j for j in self.jobs.values()
                if j.model_idx == idx and not j.running]
        for j in gone:
            if j.energy_used > 0.0:
                self.window_stats.model(j.base_name).energy_j += j.energy_used
            j.done = True
            self.ready.pop(j.jid, None)
            self.jobs.pop(j.jid, None)
            if self.soa is not None:
                self._soa_kill(j.jid)
            if self._tracer is not None:
                self._uid_of.pop(j.jid, None)
                span = self._span_of.pop(j.jid, None)
                if span is not None:
                    self._tracer.close(
                        span, self.t, outcome="purged", violated=False,
                        energy_j=j.energy_used, variant=j.graph_name,
                        segs=[list(s)
                              for s in self._segs_of.pop(j.jid, ())])
        return len(gone)

    def apply_action(self, action, t: float) -> None:
        """Apply a phase action (``repro_torch.scenarios.phases.PhaseAction``) on
        behalf of an external driver — the fleet layer forwards fleet-level
        phase events (e.g. load shifts) to the hosting nodes through this,
        exactly as a node-local phase script would."""
        self._apply_phase(action, t)

    def inject_arrival(self, name: str, t: float,
                       deadline_anchor: Optional[float] = None,
                       origin: Optional[float] = None,
                       parent_uid: Optional[str] = None,
                       xfer_s: float = 0.0) -> None:
        """Queue one externally-triggered frame of ``name`` at time ``t``
        (the fleet layer forwards cross-node cascade triggers through this).
        ``deadline_anchor`` backdates the deadline clock — a trigger that
        spent transfer latency on the wire arrives at ``t`` but its deadline
        anchors at the parent's completion time, so cross-node latency eats
        real slack.  ``origin`` carries the pipeline's head arrival time
        (defaults to ``t``) so tail completions can report head-to-tail
        pipeline latency.  ``parent_uid``/``xfer_s`` are observability
        pass-throughs (parent job span uid and wire seconds spent) — they
        affect tracing only, never scheduling.  The injected frame
        schedules no follow-up arrival."""
        self._push(t, INJECT, (self._index_of(name), deadline_anchor, origin,
                               parent_uid, xfer_s))

    # ----------------------------------------------------- SoA job mirror
    def _soa_append(self, job: Job) -> None:
        soa = self.soa
        row = soa.n
        if row == soa.cap:
            soa.grow()
        soa.jid[row] = job.jid
        soa.arrival[row] = job.arrival
        soa.deadline[row] = job.deadline
        soa.t_cmpl[row] = job.t_cmpl
        soa.energy[row] = 0.0
        soa.base_id[row] = self._base_ids.setdefault(job.base_name,
                                                     len(self._base_ids))
        soa.is_tail[row] = job.is_tail
        soa.alive[row] = True
        soa.row_of[job.jid] = row
        soa.n = row + 1
        self._soa_refresh(job, row)

    def _soa_refresh(self, job: Job, row: int) -> None:
        """Re-derive the pos/path-dependent columns of ``row`` — called
        exactly when ``job.pos`` moves (block completion) or the path and
        table change under it (supernet/SLO variant switch).  The
        next-layer cost columns are only flagged stale here; the batch
        scheduler arm (their sole reader) refreshes them on demand via
        :meth:`_soa_cost_refresh`."""
        soa = self.soa
        pos = job.pos
        tab = job.table
        soa.pos[row] = pos
        soa.togo_mean[row] = job.cum_mean[pos]
        soa.togo_min[row] = job.cum_min[pos]
        soa.energy[row] = job.energy_used
        soa.cost_stale[row] = True
        # the scheduler scores with the *pairwise* remaining-path sum
        # (mapscore.togo_seconds), not the sequential suffix cumsum above —
        # compute it here and seed the per-job memo so the scalar arm
        # never recomputes it.  Autoregressive jobs instead read the
        # precomputed predicted profile (the scheduler must not see the
        # sampled token count).
        togo = (job.sched_list[pos] if job.sched_list is not None
                else float(tab.lat_mean[job.path[pos:]].sum()))
        soa.togo_sched[row] = togo
        job._togo_at = (pos, id(tab))      # type: ignore[attr-defined]
        job._togo_v = togo                 # type: ignore[attr-defined]

    def _soa_cost_refresh(self, job: Job, row: int) -> None:
        """Bring ``row``'s next-layer cost columns up to date with
        ``job.pos`` (lazy half of :meth:`_soa_refresh`)."""
        soa = self.soa
        tab = job.table
        nxt = int(job.path[job.pos])
        soa.lat_sum_n[row] = tab.lat_sum[nxt]
        soa.en_sum_n[row] = tab.en_sum[nxt]
        soa.in_b_n[row] = tab.in_bytes[nxt]
        soa.lat_mean_n[row] = tab.lat_mean[nxt]
        soa.lat_n[row] = tab.lat[:, nxt]
        soa.en_n[row] = tab.en[:, nxt]
        soa.cost_stale[row] = False

    def _soa_kill(self, jid: int) -> None:
        soa = self.soa
        row = soa.row_of.pop(jid, None)
        if row is None:
            return
        soa.alive[row] = False
        soa.dead += 1
        if soa.dead > 16 and soa.dead > soa.n - soa.dead:
            soa.compact()

    # --------------------------------------------------------------- jobs
    def _draw_tokens(self, name: str, meta, t: float) -> int:
        """Sample (or replay) one generation length.  Draws live on the
        dedicated token stream, so genai-free populations and the
        path/cascade stream are untouched; recorded draws replay without
        consuming the stream (per-model FIFO in creation order)."""
        q = self._replay_tokens.get(name)
        if q:
            n = int(q.popleft())
        else:
            n = int(min(self.token_rng.geometric(
                1.0 / max(float(meta.token_mean), 1.0)),
                meta.max_new_tokens))
        if self.recorder is not None:
            self.recorder.tokens(t, name, n)
        return n

    def _predict_tokens(self, name: str, meta) -> float:
        """Length predictor: EWMA of this model's completed generation
        lengths, clamped to [1, cap].  Blind mode — and a cold predictor —
        prices every job at the cap (the static worst case)."""
        cap = float(meta.max_new_tokens)
        if not self.genai_predictor:
            return cap
        prev = self._tok_ewma.get(name)
        if prev is None:
            return cap
        return min(max(prev, 1.0), cap)

    def _create_job(self, model_idx: int, t: float,
                    origin: Optional[float] = None,
                    parent_uid: Optional[str] = None,
                    xfer_s: float = 0.0) -> Job:
        spec = self.specs[model_idx]
        graph = spec.model
        table = self.tables[graph.name]
        g = graph.genai
        if g is not None:
            n_tok = self._draw_tokens(graph.name, g, t)
            path = np.asarray(graph.genai_path(n_tok), dtype=np.int64)
        else:
            path = np.asarray(graph.sample_path(self.rng), dtype=np.int64)
        lat_mean = table.lat_mean[path]
        lat_min = table.lat_min[path]
        cum_mean = np.concatenate([np.cumsum(lat_mean[::-1])[::-1], [0.0]])
        cum_min = np.concatenate([np.cumsum(lat_min[::-1])[::-1], [0.0]])
        job = Job(
            jid=next(self._jid),
            model_idx=model_idx,
            base_name=graph.name,
            graph_name=graph.name,
            table=table,
            path=path,
            path_list=path.tolist(),
            cum_mean=cum_mean,
            cum_min=cum_min,
            arrival=t,
            deadline=t + self.deadlines[graph.name],
            origin=t if origin is None else origin,
            t_cmpl=t,
            worst_energy=float(table.en_max[path].sum()),
            is_tail=self._is_chain_tail(model_idx),
        )
        if g is not None:
            job.tokens_total = n_tok
            job.prefill_len = g.prefill_len
            job.decode_len = len(graph.layers) - g.prefill_len
            job.pred_tokens = self._predict_tokens(graph.name, g)
            job.sched_cum = _genai_sched_cum(
                table, path, job.prefill_len, job.decode_len,
                job.pred_tokens)
            job.sched_list = job.sched_cum.tolist()
        self.jobs[job.jid] = job
        self.ready[job.jid] = job
        heapq.heappush(
            self._stale_heap,
            (job.deadline + self.stale_periods
             * self.specs[model_idx].period_s, job.jid))
        if self.soa is not None:
            self._soa_append(job)       # variant override refreshes below
        override = self._variant_override.get(graph.name)
        if override is not None:
            # SLO degradation pin: every frame of this stream starts on the
            # pinned variant; locked so the per-job supernet engine
            # (DreamScheduler._maybe_switch_variant) keeps its hands off
            self.switch_variant(job, override)
            job.variant_locked = True
            self.variant_counts[override.name] = \
                self.variant_counts.get(override.name, 0) + 1
        if self._tracer is not None:
            uid = (f"n{self._obs_node}:j{job.jid}"
                   if self._obs_node is not None else f"j{job.jid}")
            self._uid_of[job.jid] = uid
            self._segs_of[job.jid] = []
            self._span_of[job.jid] = self._tracer.open(
                "job", t, uid=uid, model=job.base_name,
                node=self._obs_node, origin=job.origin,
                deadline=job.deadline, parent=parent_uid,
                xfer_s=xfer_s, tail=job.is_tail)
        self.scheduler.on_job_created(self, job)
        return job

    def swap_variant(self, name: str, level: int, t: float) -> ModelGraph:
        """Stream-level graceful degradation (the fleet SLO subsystem's
        actuator): pin model ``name`` to supernet-variant ``level`` — 0
        restores the original graph, k selects ``variants[k-1]`` (ordered
        heavy -> light, clamped to the ladder depth).  Takes effect for
        every job created from now on; jobs already queued or running are
        untouched (frames in flight keep their quality).  Stats keys and
        the ``worst_energy`` normalizer stay on the base graph, exactly as
        per-job supernet switching does.  Autoregressive models degrade
        *mid-generation* as well: the new level's ``max_new_tokens`` cap is
        applied to this model's queued (not running) jobs at their next
        token boundary — a long generation under pressure finishes early
        with what it has.  Returns the now-active graph."""
        graph = self.specs[self._index_of(name)].model
        if level <= 0 or not graph.variants:
            self._variant_override.pop(name, None)
            active = graph
        else:
            active = graph.variants[min(int(level), len(graph.variants)) - 1]
            self._variant_override[name] = active
        if graph.genai is not None and active.genai is not None:
            self._genai_truncate_queued(name, active.genai.max_new_tokens, t)
        return active

    def _genai_truncate_queued(self, name: str, cap: int, t: float) -> None:
        """Mid-generation degradation actuator: clamp the generation length
        of ``name``'s queued (not running) jobs to ``cap``, never below the
        tokens already (partially) emitted.  A job whose position already
        reaches the clamped path end completes immediately with what it
        has; running blocks are untouched (an accelerator cannot abandon a
        launched layer).  Promotions (cap >= sampled length) are no-ops, so
        classic populations and every pre-genai trace are unaffected."""
        idx = self._index_of(name)
        finished: list[Job] = []
        for job in self.jobs.values():
            if (job.model_idx != idx or job.running or job.done
                    or job.tokens_total <= 0):
                continue
            pl, dl = job.prefill_len, job.decode_len
            done_tok = 0 if job.pos <= pl else -((pl - job.pos) // dl)
            new_t = min(job.tokens_total, max(done_tok, int(cap)))
            if new_t >= job.tokens_total:
                continue
            table = job.table
            path = job.path[: pl + new_t * dl]
            lat_mean = table.lat_mean[path]
            lat_min = table.lat_min[path]
            job.path = path
            job.path_list = path.tolist()
            job.cum_mean = np.concatenate(
                [np.cumsum(lat_mean[::-1])[::-1], [0.0]])
            job.cum_min = np.concatenate(
                [np.cumsum(lat_min[::-1])[::-1], [0.0]])
            job.tokens_total = new_t
            job.pred_tokens = min(job.pred_tokens, float(new_t))
            job.sched_cum = _genai_sched_cum(table, path, pl, dl,
                                             job.pred_tokens)
            job.sched_list = job.sched_cum.tolist()
            if job.pos >= len(path):
                finished.append(job)
                continue
            if self.soa is not None:
                row = self.soa.row_of.get(job.jid)
                if row is not None:
                    self._soa_refresh(job, row)
        for job in finished:
            self._finish_job(job, t, dropped=False)

    def switch_variant(self, job: Job, variant: ModelGraph) -> None:
        """Supernet switching: swap the (not-yet-started) job to a lighter
        weight-sharing variant. worst_energy keeps the original's normalizer.
        Autoregressive jobs keep their sampled token count, truncated to the
        variant's ``max_new_tokens`` cap (the degradation-ladder knob)."""
        assert job.pos == 0 and not job.running
        table = self.tables[variant.name]
        g = variant.genai
        if g is not None and job.tokens_total > 0:
            n_tok = min(job.tokens_total, g.max_new_tokens)
            path = np.asarray(variant.genai_path(n_tok), dtype=np.int64)
        else:
            path = np.asarray(variant.worst_path(), dtype=np.int64)
        lat_mean = table.lat_mean[path]
        lat_min = table.lat_min[path]
        job.graph_name = variant.name
        job.table = table
        job.path = path
        job.path_list = path.tolist()
        job.cum_mean = np.concatenate([np.cumsum(lat_mean[::-1])[::-1], [0.0]])
        job.cum_min = np.concatenate([np.cumsum(lat_min[::-1])[::-1], [0.0]])
        if g is not None and job.tokens_total > 0:
            job.tokens_total = n_tok
            job.prefill_len = g.prefill_len
            job.decode_len = len(variant.layers) - g.prefill_len
            job.pred_tokens = min(job.pred_tokens, float(g.max_new_tokens))
            job.sched_cum = _genai_sched_cum(
                table, path, job.prefill_len, job.decode_len,
                job.pred_tokens)
            job.sched_list = job.sched_cum.tolist()
        elif job.tokens_total > 0:
            # the variant dropped the genai spec: the job becomes a classic
            # worst-path frame — clear the autoregressive view
            job.tokens_total = 0
            job.prefill_len = 0
            job.decode_len = 0
            job.pred_tokens = 0.0
            job.sched_cum = None
            job.sched_list = None
        if self.soa is not None:
            row = self.soa.row_of.get(job.jid)
            if row is not None:
                self._soa_refresh(job, row)

    def _finish_job(self, job: Job, t: float, dropped: bool) -> None:
        if self.soa is not None:
            self._soa_kill(job.jid)
        job.done = True
        job.dropped = dropped
        self.ready.pop(job.jid, None)
        self.jobs.pop(job.jid, None)
        violated = dropped or (t > self.deadline_of(job))
        st = self.window_stats.model(job.base_name)
        st.frames += 1
        st.violated += int(violated)
        st.energy_j += job.energy_used
        st.worst_energy_j += job.worst_energy
        self.frames += 1
        hist = self.drop_history[job.base_name]
        hist.append(dropped)
        if len(hist) > self.drop_window:
            hist.pop(0)
        uid = None
        if self._tracer is not None:
            uid = self._uid_of.pop(job.jid, None)
            span = self._span_of.pop(job.jid, None)
            if span is not None:
                self._tracer.close(
                    span, t, outcome="dropped" if dropped else "done",
                    violated=bool(violated), energy_j=job.energy_used,
                    variant=job.graph_name,
                    segs=[list(s) for s in self._segs_of.pop(job.jid, ())])
        if self._metrics is not None:
            self._m_frames.inc(node=self._node_lbl, model=job.base_name)
            if violated:
                self._m_violations.inc(node=self._node_lbl,
                                       model=job.base_name)
            if dropped:
                self._m_drops.inc(node=self._node_lbl, model=job.base_name)
            if job.energy_used > 0.0:
                self._m_energy.inc(job.energy_used, node=self._node_lbl)
            self._m_latency.observe(t - job.arrival, node=self._node_lbl)
        if not dropped:
            if job.tokens_total > 0:
                # length-predictor update: completed generations feed the
                # per-model EWMA (drops carry no length signal)
                prev = self._tok_ewma.get(job.base_name)
                tok = float(job.tokens_total)
                self._tok_ewma[job.base_name] = (
                    tok if prev is None
                    else (1.0 - TOKEN_EWMA_ALPHA) * prev
                    + TOKEN_EWMA_ALPHA * tok)
            # a completed tail (no dependents, local or remote) closes its
            # pipeline: record head-arrival -> tail-completion latency
            if job.is_tail:
                st.pipe_frames += 1
                st.pipe_latency_s += t - job.origin
            # trigger control-dependent models (cascade) on completion;
            # children inherit the pipeline origin
            for dep_idx in self._dependents_of(job.base_name):
                spec = self.specs[dep_idx]
                if self.rng.random() < spec.trigger_prob:
                    self._create_job(dep_idx, t, origin=job.origin,
                                     parent_uid=uid)
            # remote dependents (pipeline stages on other fleet nodes):
            # report the completion; the fleet clock drains and forwards
            if job.base_name in self.export_completions:
                self.pending_completions.append((job.base_name, t,
                                                 job.origin, uid))

    def deadline_of(self, job: Job) -> float:
        return job.deadline

    def drop_job(self, job: Job, t: float) -> None:
        assert not job.running
        self.drops += 1
        self._finish_job(job, t, dropped=True)

    def can_drop(self, base_name: str) -> bool:
        """Frame-drop condition 4: bounded drop rate per model."""
        hist = self.drop_history[base_name]
        return sum(hist[-self.drop_window:]) < self.max_drops_per_window

    def _abort_stale(self, t: float) -> None:
        """Simulator hygiene: a frame that has not *started* by
        deadline + stale_periods * period is abandoned (counts violated)."""
        heap = self._stale_heap
        if not heap or heap[0][0] >= t:
            # every queued head job's threshold is >= the heap minimum
            # (entries are re-armed whenever deadline or period shrink the
            # threshold), so no job can satisfy the strict t > threshold
            # test below — the ready scan would find nothing
            return
        stale = [
            j for j in self.ready.values()
            if j.pos == 0 and t > j.deadline
            + self.stale_periods * self.specs[j.model_idx].period_s
        ]
        for j in stale:
            self.aborts += 1
            self._finish_job(j, t, dropped=True)
        # expired entries are spent: any job still queued with threshold
        # < t was just aborted above (entries with threshold == t stay —
        # the strict test only fires for them at a later t)
        while heap and heap[0][0] < t:
            heapq.heappop(heap)

    # ----------------------------------------------------------- dispatch
    def _dispatch(self, d: Dispatch, t: float) -> None:
        job, acc = d.job, self.accs[d.acc_idx]
        assert not acc.busy and not job.running and not job.finished_exec
        if (self.recorder is not None and acc.prev_jid >= 0
                and acc.prev_jid != job.jid):
            pj = self.jobs.get(acc.prev_jid)
            if (pj is not None and not pj.done and not pj.running
                    and pj.tokens_total > 0 and pj.pos > pj.prefill_len):
                # token-level preemption: the decode loop this accelerator
                # was advancing yields mid-generation to another job —
                # informational record (replay derives nothing from it)
                self.recorder.preempt(t, pj.base_name, acc.idx)
        n = min(d.n_layers, job.n_layers - job.pos)
        if n < 8:
            # numpy reduces sequentially below 8 elements (pairwise blocking
            # starts at 8), so this scalar loop is bit-identical to
            # table.lat[acc.idx, layers].sum() — and skips two fancy-index
            # array allocations per dispatch (path_list keeps the loop on
            # plain ints instead of numpy scalars)
            layers = job.path_list[job.pos: job.pos + n]
            rows = _py_rows(job.table)
            lrow = rows[1][acc.idx]
            erow = rows[2][acc.idx]
            dur = 0.0
            energy = 0.0
            for li in layers:
                dur += lrow[li]
                energy += erow[li]
            if acc.prev_base is not None and acc.prev_base != job.base_name:
                energy += (rows[3][layers[0]] + acc.prev_out_bytes) * E_DRAM
                dur += self.cs_latency_s
        else:
            layers = job.path[job.pos: job.pos + n]
            dur = float(job.table.lat[acc.idx, layers].sum())
            energy = float(job.table.en[acc.idx, layers].sum())
            if acc.prev_base is not None and acc.prev_base != job.base_name:
                energy += (float(job.table.in_bytes[layers[0]])
                           + acc.prev_out_bytes) * E_DRAM
                dur += self.cs_latency_s
        reserve = dur
        if d.reserve_worst:
            # static scheduling reserves the worst-case (full) path duration
            full = self.graphs[job.graph_name].worst_path()
            reserve = float(job.table.lat[acc.idx, np.asarray(full[job.pos:])].sum())
            reserve = max(reserve, dur)
        job.energy_used += energy
        job.running = True
        job._pending_n = n  # type: ignore[attr-defined]
        job._pending_done_at = t + dur  # type: ignore[attr-defined]
        if self._tracer is not None:
            # reserve >= dur, so completion records done_at == t + dur:
            # this block is the job's exact execution interval
            segs = self._segs_of.get(job.jid)
            if segs is not None:
                segs.append((t, t + dur))
        self.ready.pop(job.jid, None)
        acc.busy = True
        acc.cur_job = job
        acc.busy_until = t + reserve
        acc.busy_time += reserve
        sink = self._slab_sink
        if sink is None:
            self._push(t + reserve, DONE, acc.idx)
        else:
            # slab done lane: same (t, seq) total order as the heap, but a
            # sorted insert into a <= n_accs entry list instead of a push
            # onto the full event heap
            insort(sink, (t + reserve, next(self._seq), acc.idx))

    def _complete(self, acc_idx: int, t: float) -> None:
        acc = self.accs[acc_idx]
        job = acc.cur_job
        assert job is not None
        n = job._pending_n  # type: ignore[attr-defined]
        done_at = min(job._pending_done_at, t)  # type: ignore[attr-defined]
        last_layer = job.path_list[job.pos + n - 1]
        job.pos += n
        job.t_cmpl = done_at
        job.running = False
        acc.busy = False
        acc.cur_job = None
        acc.prev_base = job.base_name
        acc.prev_jid = job.jid
        acc.prev_out_bytes = _py_rows(job.table)[4][last_layer]
        soa = self.soa
        if soa is not None:
            acc.prev_base_id = self._base_ids[job.base_name]
        if job.finished_exec:
            self._finish_job(job, done_at, dropped=False)
        else:
            self.ready[job.jid] = job
            if soa is not None:
                row = soa.row_of[job.jid]
                soa.t_cmpl[row] = done_at
                self._soa_refresh(job, row)

    # --------------------------------------------------------------- run
    def idle_accs(self) -> list[AccState]:
        return [a for a in self.accs if not a.busy]

    def ready_jobs(self) -> list[Job]:
        return list(self.ready.values())

    def active_jobs(self) -> list[Job]:
        """Ready or currently-executing jobs (frame-drop condition 2 scope)."""
        return [j for j in self.jobs.values() if not j.done]

    def _drain_schedule(self, t: float) -> None:
        self._abort_stale(t)
        while True:
            if not self.ready or all(a.busy for a in self.accs):
                return
            d = self.scheduler.schedule(self, t)
            if d is None:
                return
            self._dispatch(d, t)

    def start(self, at_t: float = 0.0) -> None:
        """Arm the engine: queue initial head arrivals, phase events, and the
        first UXCost window.  ``run()`` calls this; external drivers (the
        fleet clock) call it directly — a node joining a
        running fleet at time t passes ``at_t=t`` so its window clock starts
        there. (Head arrivals of a pre-populated scenario always anchor at
        stream-local 0; fleet nodes start empty and gain streams via
        ``join_model``, which anchors at the join time.)"""
        if self._started:
            raise RuntimeError("Simulator.start() called twice")
        self._started = True
        self._schedule_head_arrivals()
        self._push_phase_events()
        self._push(at_t + self.window_s, WINDOW, None)

    def peek_t(self) -> Optional[float]:
        """Time of the next queued event (None when exhausted).  WINDOW
        events self-perpetuate, so bound any polling loop by duration_s."""
        return self.events[0][0] if self.events else None

    def step(self) -> bool:
        """Process the single next event if it lies within duration_s.
        Returns False (and leaves the event queued) once the horizon is
        reached — the point at which ``finalize()`` may be called."""
        if not self.events or self.events[0][0] > self.duration_s:
            return False
        t, _, kind, arg = heapq.heappop(self.events)
        self.t = t
        prof = self._profiler
        if prof is None:
            self._process_event(t, kind, arg)
            self._drain_schedule(t)
        else:
            w0 = prof.t0()
            self._process_event(t, kind, arg)
            prof.add("node." + _EVENT_NAMES[kind], w0)
            w0 = prof.t0()
            self._drain_schedule(t)
            prof.add("node.drain", w0)
        return True

    def step_until(self, t_limit: float) -> int:
        """Process every event with time <= min(t_limit, duration_s).  The
        fleet clock interleaves nodes by advancing each to the next fleet
        event time before applying it.  Returns the number of events
        processed (0 = observable state unchanged).

        With ``soa_slab`` on, the whole span is one *time slab*: the limit
        is by construction the next point an external observer (fleet
        clock, router, trigger forwarding) can read node state, so inside
        it block completions cycle through the slab done lane without
        touching the global heap, and job state moves through the flat
        :class:`JobTable` columns.  The slab drains fully before
        returning — boundaries are exactly the scalar oracle's."""
        lim = min(t_limit, self.duration_s)
        if self.soa_slab:
            return self._slab_until(lim)
        n = 0
        while self.events and self.events[0][0] <= lim:
            self.step()
            n += 1
        return n

    def _slab_until(self, lim: float) -> int:
        """One time slab: merge the global heap with the slab done lane by
        (t, seq) — seq is globally unique, so the merged order is exactly
        the single-heap order of the scalar path — and run the same
        process/drain cycle per event, metering identically."""
        events = self.events
        dones = self._slab_dones
        prof = self._profiler
        n = 0
        try:
            self._slab_sink = dones
            while True:
                if dones:
                    dt, dseq, dacc = dones[0]
                    if events and events[0][:2] < (dt, dseq):
                        if events[0][0] > lim:
                            break
                        t, _, kind, arg = heapq.heappop(events)
                    else:
                        if dt > lim:
                            break
                        del dones[0]
                        t, kind, arg = dt, DONE, dacc
                elif events and events[0][0] <= lim:
                    t, _, kind, arg = heapq.heappop(events)
                else:
                    break
                self.t = t
                if prof is None:
                    if kind == DONE:
                        self._complete(arg, t)  # type: ignore[arg-type]
                    else:
                        self._process_event(t, kind, arg)
                    self._drain_schedule(t)
                else:
                    w0 = prof.t0()
                    if kind == DONE:
                        self._complete(arg, t)  # type: ignore[arg-type]
                    else:
                        self._process_event(t, kind, arg)
                    prof.add("node." + _EVENT_NAMES[kind], w0)
                    w0 = prof.t0()
                    self._drain_schedule(t)
                    prof.add("node.drain", w0)
                n += 1
        finally:
            self._slab_sink = None
            if dones:
                for dt, dseq, dacc in dones:
                    heapq.heappush(events, (dt, dseq, DONE, dacc))
                dones.clear()
        return n

    def _process_event(self, t: float, kind: int, arg: object) -> None:
        if kind == ARRIVAL:
            idx = int(arg)  # type: ignore[arg-type]
            if self.active[idx]:
                self._create_job(idx, t)
                if self.recorder is not None:
                    self.recorder.arrival(t, self.specs[idx].model.name)
                self._schedule_stream_arrival(idx, after_t=t)
            # an inactive (left) stream dies at its pending arrival
        elif kind == INJECT:
            idx, anchor, origin, parent_uid, xfer_s = arg  # type: ignore[misc]
            if self.active[idx]:
                job = self._create_job(idx, t, origin=origin,
                                       parent_uid=parent_uid, xfer_s=xfer_s)
                if anchor is not None:
                    name = self.specs[idx].model.name
                    job.deadline = anchor + self.deadlines[name]
                    if self.soa is not None:
                        self.soa.deadline[self.soa.row_of[job.jid]] = \
                            job.deadline
                    # the anchored deadline is earlier than the create-time
                    # one _create_job armed (anchor <= t), so re-arm the
                    # stale entry or the abort would fire late
                    heapq.heappush(
                        self._stale_heap,
                        (job.deadline + self.stale_periods
                         * self.specs[idx].period_s, job.jid))
        elif kind == PHASE:
            self._apply_phase(arg, t)
        elif kind == DONE:
            self._complete(int(arg), t)  # type: ignore[arg-type]
        elif kind == WINDOW:
            uxc = uxcost(self.window_stats)
            a, b = self._current_params()
            self.windows.append((t, uxc, a, b))
            self.scheduler.on_window(self, self.window_stats, uxc)
            for st in self.window_stats.per_model.values():
                self.merged_frames += st.frames
                self.merged_violated += st.violated
            self.global_stats.merge(self.window_stats)
            self.window_stats = WindowStats()
            self._push(t + self.window_s, WINDOW, None)

    def run(self) -> SimResult:
        self.start()
        # equivalent to `while self.step(): pass` — both drain every event
        # with t <= duration_s — but routed through step_until so the SoA
        # path runs the whole horizon as slabs
        self.step_until(self.duration_s)
        return self.finalize()

    def finalize(self) -> SimResult:
        for st in self.window_stats.per_model.values():
            self.merged_frames += st.frames
            self.merged_violated += st.violated
        self.global_stats.merge(self.window_stats)
        self.window_stats = WindowStats()  # idempotent wrt. a second call
        if self.recorder is not None:
            self.trace = self.recorder.trace()
        if self._tracer is not None and self._span_of:
            # jobs still queued/running at the horizon: close their spans
            # so the emitted JSONL is complete (outcome marks them)
            for jid in sorted(self._span_of):
                j = self.jobs.get(jid)
                self._tracer.close(
                    self._span_of[jid], self.t, outcome="unfinished",
                    violated=False,
                    energy_j=j.energy_used if j is not None else 0.0,
                    variant=j.graph_name if j is not None else None,
                    segs=[list(s) for s in self._segs_of.get(jid, ())])
            self._span_of.clear()
            self._segs_of.clear()
            self._uid_of.clear()
        util = [a.busy_time / max(self.t, 1e-9) for a in self.accs]
        return SimResult(
            scenario=self.scenario.name,
            system=self.system_name,
            scheduler=self.scheduler.name,
            duration_s=self.duration_s,
            stats=self.global_stats,
            uxcost=uxcost(self.global_stats),
            dlv_rate=overall_dlv_rate(self.global_stats),
            norm_energy=overall_norm_energy(self.global_stats),
            frames=self.frames,
            drops=self.drops,
            aborts=self.aborts,
            variant_counts=dict(self.variant_counts),
            windows=self.windows,
            acc_utilization=util,
            trace=self.trace,
            pipeline_latency_s=overall_pipeline_latency(self.global_stats),
        )

    def _current_params(self) -> tuple[float, float]:
        p = getattr(self.scheduler, "params", None)
        if p is None:
            return (0.0, 0.0)
        return (p.alpha, p.beta)


def run_sim(
    scenario: Scenario,
    system: str,
    scheduler_factory: Callable[[], SchedulerBase],
    duration_s: float = 8.0,
    seed: int = 0,
    **kw,
) -> SimResult:
    sim = Simulator(scenario, system, scheduler_factory(), duration_s=duration_s,
                    seed=seed, **kw)
    return sim.run()
