"""FleetSimulator: N DREAM nodes behind a score-driven global router
(copy of ``repro/cluster/fleet.py``).

The copy has one deviation from the reference, in the scan fleet clock
(``lazy_peek = False``, the oracle of the lazy peek heap): after a
stage-split interleave, ``_advance_all_scan`` refreshes ``recent_dlv`` and
the telemetry memo of every live node the interleave stepped, as the lazy
arm does.  The reference's scan arm steps those nodes through
``sim.step()`` and then calls ``FleetNode.advance_to``, which pops nothing
and so refreshes nothing: its router reads each stepped node's telemetry
as it stood at the last placement, and its scalar split runs differ from
its own fast path.  Whole-stream runs never reach this code.  Every other
line, the fast path included, is the reference's, and its results are
equal to the reference's bit for bit.

This module owns the fleet clock and every placement-affecting code path:
stream admission, stage-split placement, elastic membership, migration
(and its transfer-cost accounting), rebalance ticks, trace record/replay,
and the fleet-level UXCost merge.

Composes per-node discrete-event Simulators (heterogeneous Table-2 systems
per node) under one fleet clock, using the step/peek API: before each
fleet-level event — a stream arriving, a node joining/leaving/draining, a
rebalance tick — every live node is advanced to the event time, so the
router always reads telemetry that is causally consistent across the fleet.

Two placement granularities:

  * **whole-stream** (default) — a stream (head + cascade children) lands
    on one node; cascades trigger inside that node's simulator.  This is
    the original behavior, preserved bit-exactly.
  * **stage-split** (``split_stages=True`` + a ``TransferModel``) — the
    router places each pipeline *stage* independently.  Cascade edges that
    cross nodes become fleet-level triggers: the parent node exports the
    completion, the fleet draws the trigger probability from a dedicated
    RNG stream, charges the activation transfer (latency delays the child
    and eats its deadline slack; energy lands in the fleet UXCost merge),
    and injects the frame into the child's node.  Causal consistency is
    kept by an *interleaved* advance: nodes step strictly in global event
    order (ties broken by node id) so a trigger is always injected before
    its target passes the injection time.

Elastic membership is first-class:

  * ``node_join``  — a fresh (empty) node starts mid-run; its UXCost window
    clock anchors at the join time.
  * ``node_drain`` — graceful: streams migrate away, the node finishes its
    queue but accepts no new placements.
  * ``node_leave`` — abrupt: streams migrate, jobs in flight are lost.

And so is the *stream lifecycle* — the load-release half of the paper's
task-level dynamicity:

  * ``depart`` — a stream stops mid-run: it is evicted from its hosting
    node(s), its queued (not-yet-running) frames are purged without
    counting against UXCost, the touched nodes' probes re-arm, and so
    does the fleet weight tuner.  Frames served while the stream was
    present stay in the UXCost merge.
  * ``rejoin`` — a departed stream returns: the router re-places its
    recorded definition under a fresh placement generation, exactly like
    a new arrival.

Overload is a managed regime (the SLO subsystem, :mod:`.slo`): streams
declare service tiers, and with ``slo=True`` (or a config) an
:class:`~.slo.AdmissionController` gates every arrival/rejoin — admit,
admit one supernet-variant level down, or **reject** (a first-class
outcome: the refused head frames accrue as deadline violations in the
fleet UXCost merge, never a silent drop).  ``slo_every_s`` ticks walk the
degradation ladder over placed streams: under sustained pressure the
weakest tiers pin to cheaper supernet variants
(``Simulator.swap_variant``), and they promote back one level per tick
once pressure falls below the hysteresis band.  Tier-0 ("guaranteed")
streams are never degraded or rejected.  Every controller decision is
recorded (``swap`` / ``reject`` trace records), so replay applies them as
inputs and bypasses the controller bit-exactly; runs without a controller
never touch the variant plumbing and stay bit-identical to pre-SLO
builds.

Transfers (migrations *and* cross-node cascade triggers) are realized
over shared per-node-pair links
(:class:`repro_torch.core.costmodel.ContendedLinks`):
with a finite ``link_bandwidth_bytes_s`` concurrent transfers on one
node pair queue FIFO for the wire, so ``W_XFER`` penalties and migration
delays reflect load-dependent realized times; the default (infinite link
bandwidth) is uncontended and bit-identical to the historical model.

Under a ``TransferModel``, every migration (drain/leave/rebalance) charges
the moved model state exactly once: the re-placement is delayed by the
state-transfer latency and the link energy is added to the moved model's
fleet UXCost entry.  With ``bandwidth_bytes_s == 0`` there is no usable
inter-node link: stage placement degenerates to whole-pipeline co-location
and migrations fall back to reloading weights from node-local storage
(energy charged, no wire delay).

Every placement-affecting event re-triggers the (alpha, beta) adaptivity
probe on the touched nodes (``DreamScheduler.retrigger_probe``), mirroring
the paper's workload-change response.

Two adaptivity loops close over the fleet clock:

  * **fleet phase events** (``FleetScenarioBuilder.phase``) are
    stream-addressed workload mutations (e.g. diurnal ``scale_fps``
    shifts) forwarded to the hosting nodes as node-local phase actions;
    they re-arm the touched nodes' probes and update the stream's own
    definition so later migrations re-place at the shifted rate.
  * **tune ticks** (``tune_every_s``) close a fleet telemetry window
    (:class:`~.telemetry.FleetTelemetry`) and feed it to the routing
    policy's weight tuner when it has one (``tuned_score``): the
    fleet-scale analogue of the per-node (alpha, beta) probe, re-armed on
    membership churn and phase events.  Tuner decisions are recorded in
    the trace, so replay installs the recorded weights and never
    constructs telemetry or steps the probe.

With ``record=True`` the run emits a :class:`~.trace.FleetTrace` capturing
inputs *and* routing decisions (stage-level when splitting); constructing
a FleetSimulator from that trace (``replay=...``) bypasses the router and
reproduces the run bit-exactly — cross-node triggers are re-derived from
the recorded placements via the deterministic interleaved clock and the
dedicated trigger RNG, so they need no trace records of their own.

Invariants:

  * placement-generation namespacing — a (stream, stage) re-placed after a
    migration gets a fresh ``g<N>`` name prefix, so it can never collide
    with an earlier residency on the same node; UXCost merging collapses
    the generations back to one logical model per stream.
  * stage-split cascade draws are *counter-based*: the n-th completion of
    a cascade edge draws from a generator keyed by (fleet seed, stream,
    edge, n), so trigger realizations are a property of the workload, not
    of placement or interleave order — different placements of one
    scenario face identical cascades, and whole-stream runs (which draw
    triggers inside their node simulators) are untouched.
"""
from __future__ import annotations

import copy
import dataclasses
import heapq
import re
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..core.costmodel import (ContendedLinks, TransferModel,
                              activation_bytes, model_state_bytes)
from ..core.engine import EngineConfig
from ..core.scheduler import dream_full
from ..core.simulator import SchedulerBase
from ..core.uxcost import (WindowStats, overall_dlv_rate,
                           overall_norm_energy, overall_pipeline_latency,
                           uxcost)
from ..obs import Obs
from ..scenarios.builder import ModelEntry
from ..scenarios.phases import PhaseAction

from .builder import FleetScenario
from .node import FleetNode, StreamCost
from .router import (RouterPolicy, ScoreDrivenRouter, argmin_node,
                     make_policy)
from .slo import (DEFAULT_SLO, AdmissionController, StreamState,
                  slo_from_config)
from .telemetry import FleetTelemetry
from .trace import FleetTrace, FleetTraceRecorder

#: domain-separation constant for stage-split cascade trigger draws
_TRIGGER_STREAM = 0x7819
_U64 = (1 << 64) - 1


def _hash_u01(*keys: int) -> float:
    """Deterministic uniform in [0, 1) from integer keys: a boost-style
    hash combine followed by the splitmix64 finalizer.  Used for the
    counter-based cascade trigger draws — constructing a numpy Generator
    per draw would dominate the interleave hot path, and a keyed hash
    gives the same placement-independence at a fraction of the cost."""
    x = 0x9E3779B97F4A7C15
    for k in keys:
        x = (x ^ ((k & _U64) + 0x9E3779B97F4A7C15
                  + ((x << 6) & _U64) + (x >> 2))) & _U64
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    x ^= x >> 31
    return x / 2.0 ** 64


def node_seed(fleet_seed: int, node_id: int) -> int:
    """Per-node RNG seed: stable across record and replay."""
    return fleet_seed + 7919 * (node_id + 1)


#: placement namespacing in model names: "s<sid>[t<stage>][g<gen>].<base>"
_GEN_RE = re.compile(r"^(s\d+)(?:t\d+)?(?:g\d+)?\.")


def canonical_stream_model(name: str) -> str:
    """Collapse placement generations and stage indices: a stream migrated
    across nodes (or split into stages) is one logical model per base name
    in the fleet UXCost merge ("s12g2.det" -> "s12.det", "s12t1g2.track"
    -> "s12.track"), so moving or splitting does not fragment its
    DLV-floor / energy accounting."""
    return _GEN_RE.sub(r"\1.", name)


class StreamView:
    """Router-facing view of one stream (a pipeline of cascade stages).

    Holds the *original* (un-namespaced) pipeline entries so cost estimates
    share memoized tables across streams and placement generations; graphs
    materialize lazily, and per-node costs cache by system type (they
    depend only on the node's accelerator mix, not its live state).

    The stage surface (``stage_cost_on`` / ``stage_spec`` / ``parent_of`` /
    ``children_of``) exposes each pipeline stage as an independently
    placeable unit; ``stage_weight`` is the cumulative trigger probability
    from the head, so offered-load estimates reflect each stage's true
    arrival rate (head fps x product of trigger probabilities)."""

    def __init__(self, sid: int, entry_cfgs: list[dict]):
        self.sid = sid
        # own the configs: phase events rescale them in place, and the
        # originals belong to the scenario (shared across runs) and to the
        # recorded trace (which must keep the admission-time workload).
        # Only the top-level "fps" key is ever mutated (rescale_fps), so a
        # per-dict shallow copy suffices — nested model/arrival dicts are
        # read-only and may stay shared with the scenario.
        self.entry_cfgs = [dict(c) for c in entry_cfgs]
        self.entries = [ModelEntry.from_config(c) for c in self.entry_cfgs]
        #: SLO pipeline budget in head periods (the stream tier's
        #: ``SLOClass.budget_factor``), installed by the fleet at arrival.
        #: Budget-aware routers divide routing urgency by it; the 1.0
        #: default keeps budget-blind scoring bit-identical
        self.budget_factor = 1.0
        self._graphs: Optional[list] = None
        self._cost_by_system: dict[object, StreamCost] = {}
        self._stage_graphs: Optional[list] = None
        self._stage_cost: dict[object, StreamCost] = {}
        # cascade topology: parent index + children (index, trigger_prob)
        name_to_idx = {e.model_name: i for i, e in enumerate(self.entries)}
        self._parent: list[Optional[int]] = []
        self._children: dict[int, list[tuple[int, float]]] = {}
        self._weight: list[float] = []
        for i, e in enumerate(self.entries):
            if e.depends_on is None:
                self._parent.append(None)
                self._weight.append(1.0)
            else:
                p = name_to_idx[e.depends_on]
                self._parent.append(p)
                self._weight.append(self._weight[p] * e.trigger_prob)
                self._children.setdefault(p, []).append((i, e.trigger_prob))

    @property
    def n_stages(self) -> int:
        return len(self.entries)

    @property
    def head_period_s(self) -> float:
        return 1.0 / self.entries[0].fps

    def rescale_fps(self, factor: float) -> None:
        """Apply a fleet phase event's FPS rescale to the stream's *own*
        definition, so later re-placements (drain/leave/rebalance
        migrations) materialize specs at the shifted rate instead of
        silently reverting to the admission-time load.  Cost caches that
        embed rates are invalidated; cascade topology and per-stage graphs
        (rate-independent) survive."""
        for cfg in self.entry_cfgs:
            cfg["fps"] = float(cfg["fps"]) * factor
        self.entries = [ModelEntry.from_config(c) for c in self.entry_cfgs]
        self._graphs = None
        self._cost_by_system = {}
        self._stage_cost = {}

    # ------------------------------------------------------ whole-stream
    def _graph_loads(self) -> list:
        if self._graphs is None:
            self._graphs = [
                (e.ref.build(), e.fps,
                 1.0 if e.depends_on is None else e.trigger_prob)
                for e in self.entries
            ]
        return self._graphs

    def cost_on(self, node: FleetNode) -> StreamCost:
        key = node.system if node.system != "custom" else ("node", node.node_id)
        hit = self._cost_by_system.get(key)
        if hit is None:
            hit = node.stream_cost(self._graph_loads(), self.head_period_s)
            self._cost_by_system[key] = hit
        return hit

    def namespaced_specs(self, gen: int) -> tuple[list, list[str]]:
        """Materialize placement-generation-``gen`` ModelSpecs for a whole-
        stream placement.  Names are prefixed per (stream, generation) so
        re-placements never collide with an earlier residency of the same
        stream on the same node."""
        prefix = f"s{self.sid}." if gen == 0 else f"s{self.sid}g{gen}."
        specs, names = [], []
        for cfg in self.entry_cfgs:
            # shallow rebuild: only the two renamed keys get fresh dicts
            c = dict(cfg)
            m = dict(c["model"])
            base = m["name"]
            m["name"] = prefix + base
            c["model"] = m
            if c.get("depends_on"):
                c["depends_on"] = prefix + c["depends_on"]
            specs.append(ModelEntry.from_config(c).to_spec())
            names.append(prefix + base)
        return specs, names

    # ------------------------------------------------------- stage surface
    def parent_of(self, k: int) -> Optional[int]:
        """Index of stage ``k``'s cascade parent (None for heads)."""
        return self._parent[k]

    def children_of(self, k: int) -> list[tuple[int, float]]:
        """(stage index, trigger probability) of stage ``k``'s dependents."""
        return self._children.get(k, [])

    def stage_base(self, k: int) -> str:
        return self.entries[k].model_name

    def stage_weight(self, k: int) -> float:
        """Cumulative trigger probability from the head (1.0 for heads)."""
        return self._weight[k]

    def stage_period_s(self, k: int) -> float:
        return 1.0 / self.entries[k].fps

    def stage_graph(self, k: int):
        if self._stage_graphs is None:
            self._stage_graphs = [e.ref.build() for e in self.entries]
        return self._stage_graphs[k]

    def act_bytes_into(self, k: int) -> float:
        """Bytes a cross-node trigger into stage ``k`` ships (the parent's
        final activation); 0.0 for heads."""
        p = self._parent[k]
        return 0.0 if p is None else activation_bytes(self.stage_graph(p))

    def state_bytes(self, k: int) -> float:
        """Bytes a migration of stage ``k`` ships (its weight state)."""
        return model_state_bytes(self.stage_graph(k))

    def stage_cost_on(self, node: FleetNode, k: int) -> StreamCost:
        sys_key = (node.system if node.system != "custom"
                   else ("node", node.node_id))
        key = (sys_key, k)
        hit = self._stage_cost.get(key)
        if hit is None:
            rate = self.entries[0].fps * self.stage_weight(k)
            hit = node.stream_cost([(self.stage_graph(k), rate, 1.0)],
                                   self.stage_period_s(k))
            self._stage_cost[key] = hit
        return hit

    def stage_spec(self, k: int, gen: int):
        """Materialize stage ``k`` at placement generation ``gen`` as a
        standalone ModelSpec.  Non-head stages lose their local cascade
        dependency and get a ``triggered`` arrival process: their frames
        come only from fleet-forwarded triggers (same-node edges included,
        so a stream's dynamics do not change when a stage migrates)."""
        prefix = (f"s{self.sid}t{k}." if gen == 0
                  else f"s{self.sid}t{k}g{gen}.")
        c = dict(self.entry_cfgs[k])
        m = dict(c["model"])
        base = m["name"]
        m["name"] = prefix + base
        c["model"] = m
        if c.get("depends_on") is not None:
            c["depends_on"] = None
            c["arrival"] = {"kind": "triggered"}
        return ModelEntry.from_config(c).to_spec(), prefix + base


@dataclass
class FleetResult:
    name: str
    policy: str
    duration_s: float
    n_nodes: int                 # nodes ever joined
    n_streams: int
    stats: WindowStats           # fleet-merged per-model window stats
    uxcost: float                # fleet UXCost (Algorithm 2 on the merge)
    dlv_rate: float
    norm_energy: float
    frames: int
    drops: int
    migrations: int
    probe_retriggers: int
    per_node: list[dict]
    trace: Optional[FleetTrace] = None
    split: bool = False          # stage-split placement was enabled
    stage_migrations: int = 0    # migrations that moved a single stage
    trigger_transfers: int = 0   # cascade triggers that crossed nodes
    xfer_energy_j: float = 0.0   # total transfer energy charged to UXCost
    weights: Optional[tuple] = None   # final router weights (score family)
    tuner_windows: int = 0       # telemetry windows the tuner consumed
    tuner_commits: int = 0       # probe mini-cycles that moved the center
    tuner_retriggers: int = 0    # tuner re-arms (churn + phase events)
    pipeline_latency_s: float = 0.0  # mean head-to-tail latency, wire incl.
    pipe_frames: int = 0         # pipelines completed head-to-tail
    departures: int = 0          # stream depart events applied
    rejoins: int = 0             # stream rejoin events applied
    jobs_purged: int = 0         # queued jobs discarded by departures
    link_transfers: int = 0      # transfers routed over shared links
    link_queued: int = 0         # of which waited on a busy link
    link_wait_s: float = 0.0     # total link queueing delay experienced
    slo_enabled: bool = False    # an admission controller gated this run
    rejections: int = 0          # streams refused admission
    swaps: int = 0               # SLO variant-level changes applied
    promotions: int = 0          # of which promoted back toward quality
    reject_frames: int = 0       # pseudo-frames charged for rejections
    #: frames / DLV rate per SLO tier (tierless streams count as tier 1)
    tier_frames: dict = field(default_factory=dict)
    tier_dlv: dict = field(default_factory=dict)
    stream_seconds: float = 0.0  # simulated stream-seconds served

    def summary(self) -> str:
        return (f"fleet[{self.policy:>11s}] nodes={self.n_nodes:<3d} "
                f"streams={self.n_streams:<4d} UXCost={self.uxcost:10.4f} "
                f"DLV={self.dlv_rate:6.3f} frames={self.frames} "
                f"drops={self.drops} migr={self.migrations}")


class _CandidateList(list):
    """Sorted live-node candidate list with fleet-backed SoA telemetry
    columns.  Batched routers call :meth:`tel_columns` to read per-node
    telemetry as flat arrays (refreshed via the node dirty hooks) instead
    of 8 attribute reads per node per placement; scalar paths just treat
    it as the plain list it is."""

    _fleet: "FleetSimulator"

    def tel_columns(self) -> dict:
        return self._fleet._tel_columns(self)


class FleetSimulator:
    """Drive a FleetScenario (or a recorded FleetTrace) to completion."""

    def __init__(
        self,
        scenario: Optional[FleetScenario] = None,
        policy: "str | RouterPolicy" = "score",
        *,
        duration_s: float = 4.0,
        seed: int = 0,
        window_s: float = 0.5,
        scheduler_factory: Optional[Callable[[int], SchedulerBase]] = None,
        record: bool = False,
        replay: Optional[FleetTrace] = None,
        rebalance_every_s: Optional[float] = None,
        rebalance_hysteresis: float = 0.15,
        transfer: Optional[TransferModel] = None,
        split_stages: bool = False,
        tune_every_s: Optional[float] = None,
        slo: "bool | dict | AdmissionController | None" = None,
        slo_every_s: Optional[float] = None,
        genai_predictor: bool = True,
        engine: "EngineConfig | str | None" = None,
        obs: "bool | dict | Obs | None" = None,
        lazy_peek: "bool | None" = None,
    ):
        if (scenario is None) == (replay is None):
            raise ValueError("pass exactly one of scenario or replay")
        self.replay = replay
        if replay is not None:
            meta = replay.meta
            self.name = meta.get("scenario", "replayed-fleet")
            self.policy = make_policy(meta.get("policy", "score"))
            duration_s = float(meta["duration_s"])
            seed = int(meta["seed"])
            window_s = float(meta["window_s"])
            rebalance_every_s = None    # decisions come from the trace
            tune_every_s = None         # recorded `tune` events carry them
            transfer = (TransferModel.from_config(meta["transfer"])
                        if "transfer" in meta else None)
            split_stages = bool(meta.get("split", False))
            slo = None              # recorded swap/reject events carry them
            slo_every_s = None
            genai_predictor = bool(meta.get("genai_predictor", True))
            self._events = [(e["t"], e["type"], e) for e in replay.events]
        else:
            self.name = scenario.name
            self.policy = make_policy(policy)
            self._events = [(e.t, e.kind, dict(e.payload, t=e.t))
                            for e in scenario.events]
        if split_stages and transfer is None:
            raise ValueError("split_stages requires a TransferModel: "
                             "stage placement is priced by transfer cost")
        self.transfer = transfer
        self.split = bool(split_stages)
        self.duration_s = duration_s
        self.seed = seed
        self.window_s = window_s
        self.scheduler_factory = (scheduler_factory
                                  or (lambda s: dream_full(seed=s)))
        #: scheduler identity, recorded in traces: replaying with a
        #: different per-node scheduler would silently diverge
        self._scheduler_name = self.scheduler_factory(0).name
        if replay is not None:
            expected = replay.meta.get("scheduler")
            if expected is not None and expected != self._scheduler_name:
                raise ValueError(
                    f"trace was recorded with scheduler {expected!r}; pass a "
                    f"matching scheduler_factory (got "
                    f"{self._scheduler_name!r})")
        if rebalance_every_s is not None and not rebalance_every_s > 0:
            raise ValueError("rebalance_every_s must be positive")
        if tune_every_s is not None and not tune_every_s > 0:
            raise ValueError("tune_every_s must be positive")
        if slo_every_s is not None and not slo_every_s > 0:
            raise ValueError("slo_every_s must be positive")
        self.rebalance_every_s = rebalance_every_s
        self.rebalance_hysteresis = rebalance_hysteresis
        self.tune_every_s = tune_every_s
        #: per-node generation-length predictor toggle (False = blind
        #: ablation: autoregressive jobs priced at their max_new_tokens cap)
        self.genai_predictor = genai_predictor
        if lazy_peek is not None:
            # legacy flag shim: pre-EngineConfig callers toggled the fleet
            # clock arm directly; fold it into the config
            warnings.warn(
                "FleetSimulator(lazy_peek=...) is deprecated; pass "
                "engine=EngineConfig(..., lazy_peek=...) instead",
                DeprecationWarning, stacklevel=2)
            cfg = EngineConfig.make(engine) or EngineConfig()
            engine = dataclasses.replace(cfg, lazy_peek=lazy_peek)
        #: engine arm selection (None = class-attribute behavior); applied
        #: fleet-wide here and per node at FleetNode construction
        self.engine = EngineConfig.make(engine)
        if self.engine is not None:
            self.engine.apply_fleet(self)
        #: SLO admission controller (live runs only — replay applies the
        #: recorded swap/reject decisions and never runs the controller);
        #: ``slo_every_s`` paces the degradation-ladder ticks (None = gate
        #: arrivals only, no periodic ladder)
        self.slo = AdmissionController.make(slo)
        self.slo_every_s = slo_every_s
        if self.slo is None and slo_every_s is not None:
            raise ValueError("slo_every_s requires an admission controller "
                             "(pass slo=True or a config)")
        #: dedicated telemetry aggregator for the controller: windows are
        #: snapshot deltas, so sharing the tuner's instance would perturb
        #: the tuner's feedback whenever the tick cadences differ
        self._slo_tel = (FleetTelemetry(canonical=canonical_stream_model)
                         if self.slo is not None else None)
        #: windowed fleet telemetry, fed at tune ticks (live runs only —
        #: replay bypasses telemetry and tuner entirely)
        self.telemetry = FleetTelemetry(canonical=canonical_stream_model)
        #: dedicated RNG stream for the weight tuner's distant samples;
        #: replay never draws from it (tune decisions come from the trace)
        self._tuner_rng = np.random.default_rng([seed, 0x7D5E])
        self.tuner_retriggers = 0
        #: realized transfer times over shared per-node-pair links —
        #: uncontended (infinite link bandwidth) unless the TransferModel
        #: says otherwise; replay reconstructs it from the trace meta and
        #: re-derives identical queueing because the fleet clock totally
        #: orders transfer requests
        self.links = ContendedLinks(transfer) if transfer is not None else None
        # ------------------------------------------------ observability
        # one Obs bundle is shared fleet-wide: node simulators trace into
        # the same tracer/registry (tagged by node id), the admission
        # controller, links, and tuner publish into the same registry.
        # Every hook below is observation-only behind an ``is not None``
        # guard: obs-off runs take the identical code path as before, and
        # obs-on runs consume no RNG — both stay bit-exact (tests assert).
        self.obs = Obs.make(obs)
        self._tracer = self.obs.tracer if self.obs is not None else None
        self._metrics = self.obs.metrics if self.obs is not None else None
        self._profiler = self.obs.profiler if self.obs is not None else None
        if self._metrics is not None:
            if self.links is not None:
                self.links.metrics = self._metrics
            if self.slo is not None:
                self.slo.metrics = self._metrics
            if hasattr(type(self.policy), "metrics"):
                self.policy.metrics = self._metrics
            self._m_place = self._metrics.counter(
                "fleet_placements_total", "stream/stage placements",
                ("node",))
            self._m_migr = self._metrics.counter(
                "fleet_migrations_total", "stream/stage migrations",
                ("src", "dst"))
            self._m_rej = self._metrics.counter(
                "fleet_rejections_total", "streams refused admission",
                ("tier",))
            self._m_swap = self._metrics.counter(
                "fleet_swaps_total", "SLO degradation-ladder moves",
                ("direction",))
            self._m_trig = self._metrics.counter(
                "fleet_trigger_transfers_total",
                "cascade triggers that crossed nodes")
            self._m_streams = self._metrics.gauge(
                "fleet_streams", "streams currently placed")
        else:
            self._m_place = self._m_migr = self._m_rej = None
            self._m_swap = self._m_trig = self._m_streams = None
        #: simulated stream-seconds served (placement -> departure/end),
        #: accumulated regardless of obs so streams_per_wall_s is always
        #: derivable; rejected streams contribute nothing
        self.stream_seconds = 0.0
        self._stream_t0: dict[int, float] = {}
        self.nodes: dict[int, FleetNode] = {}
        #: _candidates() memo, cleared on any membership change
        self._cands_cache: dict[Optional[int], list[FleetNode]] = {}
        #: SoA telemetry columns over one candidate list (see _tel_columns)
        self._tel_cols: Optional[dict] = None
        self._tel_dirty: set[int] = set()
        #: persistent lazy (peek_t, node_id) min-heap driving the fleet
        #: clock: only nodes with events actually due are advanced, instead
        #: of rescanning every node at every fleet event.  Entries are
        #: lazily stale (a popped entry is re-validated against the node's
        #: true peek); the invariant is one-sided — the heap always holds
        #: an entry at or before each live node's true next-event time, so
        #: every operation that can schedule an *earlier* event on a node
        #: must call :meth:`_touch` (operations that only delay or remove
        #: events need not: early entries refresh themselves on pop)
        self._peek_heap: list[tuple[float, int]] = []
        #: node id -> time of its earliest live heap entry.  Entries a
        #: newer, earlier push superseded are discarded on pop instead of
        #: recycling forever, so the heap stays O(nodes), not O(touches)
        self._peek_at: dict[int, float] = {}
        #: node ids stepped by the current interleave pass (split mode),
        #: pending their recent-DLV refresh
        self._stepped: set[int] = set()
        self.streams: dict[int, StreamView] = {}
        self.stream_node: dict[int, int] = {}   # sid -> hosting node id
        self.gen: dict[int, int] = {}           # sid -> placement generation
        #: streams currently departed (lifecycle released); a rejoin
        #: removes the sid again.  Departed streams keep their StreamView
        #: (the rejoin re-places from it) but hold no placements.
        self.departed: set[int] = set()
        self.departures = 0
        self.rejoins = 0
        self.jobs_purged = 0
        # ---- SLO state, maintained identically live and in replay (live
        # decisions come from the controller, replayed ones from the trace)
        #: sid -> declared SLO class (absent = legacy tierless stream)
        self.stream_slo: dict[int, "object"] = {}
        #: sid -> current degradation-ladder level; presence (even at level
        #: 0) marks a stream the controller has touched — never-touched
        #: streams skip the variant plumbing entirely, which is what keeps
        #: a controller-free run bit-identical to the pre-SLO simulator
        self.slo_level: dict[int, int] = {}
        #: streams refused admission (cleared again by a depart)
        self.rejected: set[int] = set()
        #: sid -> (reject time, head fps) while the rejection span is open
        self._reject_open: dict[int, tuple[float, float]] = {}
        #: sid -> refused head frames accumulated over closed spans
        self._reject_frames: dict[int, float] = {}
        #: sid -> variant-ladder depth (max over stages), memoized
        self._ladder_cache: dict[int, int] = {}
        self.rejections = 0
        self.swaps = 0
        self.promotions = 0
        # stage-split bookkeeping, keyed by (sid, stage)
        self.stage_node: dict[tuple[int, int], int] = {}
        self.stage_gen: dict[tuple[int, int], int] = {}
        self.stage_name: dict[tuple[int, int], str] = {}
        #: when each stage's state is resident on its current node — a
        #: migrated stage cannot serve triggers while its weights are
        #: still on the wire
        self.stage_ready: dict[tuple[int, int], float] = {}
        #: namespaced name -> (sid, stage); grows only — in-flight jobs of a
        #: migrated-away residency still resolve their logical stage
        self._name_stage: dict[str, tuple[int, int]] = {}
        #: canonical model name -> transfer energy charged (J)
        self.xfer_energy: dict[str, float] = {}
        #: per-edge completion counters for counter-based trigger draws
        self._trigger_counts: dict[tuple[int, int], int] = {}
        self.migrations = 0
        self.stage_migrations = 0
        self.trigger_transfers = 0
        self.recorder = None
        self.trace: Optional[FleetTrace] = None
        if record:
            if replay is not None:
                raise ValueError("record and replay are mutually exclusive")
            meta = {
                "scenario": self.name, "policy": self.policy.name,
                "scheduler": self._scheduler_name,
                "seed": seed, "duration_s": duration_s,
                "window_s": window_s,
            }
            if self.transfer is not None:
                meta["transfer"] = self.transfer.to_config()
            if self.split:
                meta["split"] = True
            if self.tune_every_s is not None:
                # documentation only: replay takes weights from the
                # recorded `tune` events, never from a live tuner
                meta["tune_every_s"] = self.tune_every_s
            if self.slo is not None:
                # documentation only, like tune_every_s: replay applies the
                # recorded swap/reject decisions, never the controller —
                # and SLO-free runs keep their meta byte-identical
                meta["slo"] = self.slo.to_config()
                if self.slo_every_s is not None:
                    meta["slo_every_s"] = self.slo_every_s
            if not self.genai_predictor:
                # non-default only: legacy traces keep identical headers
                meta["genai_predictor"] = False
            self.recorder = FleetTraceRecorder(meta)

    # ---------------------------------------------------------- plumbing
    #: fleet-clock toggle: True drives advancement from the persistent
    #: lazy peek heap (only nodes with due events pay anything per fleet
    #: event); False rescans every node per event — the original O(N)
    #: path, kept alive as the equivalence-test oracle.  Both paths step
    #: each node's events in the identical (event time, node id) order,
    #: and skipping a node with nothing due is a pure no-op, so the flag
    #: never changes results.
    lazy_peek = True

    def _advance_all(self, t: float) -> None:
        """Advance every live node with due events to fleet time ``t``.
        Whole-stream mode advances node by node (cascades are node-local,
        so cross-node order is irrelevant — and this is the original
        bit-exact path).  Stage-split mode interleaves nodes in global
        event order so cross-node triggers inject causally."""
        if not self.lazy_peek:
            self._advance_all_scan(t)
            return
        if self.split:
            self._interleave_to(t)
            # only stepped nodes can have moved their frame counters; the
            # scan path's post-sweep touched every node, but a no-step
            # refresh never changes recent_dlv or telemetry
            for nid in self._stepped:
                node = self.nodes[nid]
                if node.alive:
                    node._update_recent_dlv()
                    node._invalidate_telemetry()
            self._stepped.clear()
            return
        heap = self._peek_heap
        while heap and heap[0][0] <= t:
            pt, nid = heapq.heappop(heap)
            if self._peek_at.get(nid) != pt:
                continue            # superseded by an earlier push
            del self._peek_at[nid]
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                continue            # departed member; entry is garbage
            cur = node.sim.peek_t()
            if cur is None:
                continue
            if cur > self._node_lim(node, t):
                if cur > t:
                    # nothing due yet — keep tracking the future event
                    self._push_peek(nid, cur)
                # else: past the node's own horizon, unreachable — drop
                continue
            node.advance_to(t)
            nxt = node.sim.peek_t()
            if nxt is not None:
                self._push_peek(nid, nxt)

    def _advance_all_scan(self, t: float) -> None:
        """Reference fleet clock: full rescan of every node per event.
        The interleave steps nodes through ``sim.step()``, so the
        ``advance_to`` sweep below pops nothing on them and would leave
        their ``recent_dlv`` and telemetry memo as they stood before the
        steps; they are refreshed here, as the lazy arm refreshes the
        nodes it stepped."""
        if self.split:
            for nid in sorted(self._interleave_to_scan(t)):
                node = self.nodes[nid]
                if node.alive:
                    node._update_recent_dlv()
                    node._invalidate_telemetry()
        for nid in sorted(self.nodes):
            self.nodes[nid].advance_to(t)

    def _push_peek(self, nid: int, pt: float) -> None:
        cur = self._peek_at.get(nid)
        if cur is not None and cur <= pt:
            return                  # an entry at/before pt already lives
        self._peek_at[nid] = pt
        heapq.heappush(self._peek_heap, (pt, nid))

    def _touch(self, nid: int) -> None:
        """Re-arm the peek heap after an operation that may have scheduled
        an earlier event on node ``nid``'s simulator (placement, phase
        action, cascade injection, join)."""
        node = self.nodes.get(nid)
        if node is None or not node.alive:
            return
        pt = node.sim.peek_t()
        if pt is not None:
            self._push_peek(nid, pt)

    def _node_lim(self, node: FleetNode, t: float) -> float:
        return min(t, node.sim.duration_s)

    def _interleave_to(self, t: float) -> None:
        """Step all live nodes' simulators in global event-time order
        (ties: lowest node id first) off the persistent peek heap, draining
        exported cascade completions after every step and injecting the
        resulting triggers — possibly into other nodes, whose heap entries
        are refreshed lazily.  A node is only stepped when its popped entry
        matches its true peek, so the realized step order is the same
        (time, node id) sequence the scan-based oracle produces."""
        heap = self._peek_heap
        stepped = self._stepped
        while heap and heap[0][0] <= t:
            pt, nid = heapq.heappop(heap)
            if self._peek_at.get(nid) != pt:
                continue            # superseded by an earlier push
            del self._peek_at[nid]
            node = self.nodes.get(nid)
            if node is None or not node.alive:
                continue
            cur = node.sim.peek_t()
            if cur is None:
                continue
            if cur > self._node_lim(node, t):
                if cur > t:
                    self._push_peek(nid, cur)
                continue            # stale entry; node has nothing due
            if cur != pt:
                self._push_peek(nid, cur)
                continue            # refresh stale entry, keep ordering
            node.sim.step()
            stepped.add(nid)
            for t_inj, dst in self._drain_triggers(node):
                dnode = self.nodes[dst]
                if dst != nid and dnode.alive:
                    self._push_peek(dst, t_inj)
            nxt = node.sim.peek_t()
            if nxt is not None:
                self._push_peek(nid, nxt)

    def _interleave_to_scan(self, t: float) -> set[int]:
        """Reference interleave: rebuild a fresh heap from a full node scan
        (the pre-lazy-peek path, kept as the equivalence-test oracle).
        Returns the ids of the nodes it stepped."""
        stepped: set[int] = set()
        heap: list[tuple[float, int]] = []
        for nid in sorted(self.nodes):
            node = self.nodes[nid]
            if not node.alive:
                continue
            pt = node.sim.peek_t()
            if pt is not None and pt <= self._node_lim(node, t):
                heapq.heappush(heap, (pt, nid))
        while heap:
            pt, nid = heapq.heappop(heap)
            node = self.nodes[nid]
            if not node.alive:
                continue
            cur = node.sim.peek_t()
            if cur is None or cur > self._node_lim(node, t):
                continue            # stale entry; node has nothing due
            if cur != pt:
                heapq.heappush(heap, (cur, nid))
                continue            # refresh stale entry, keep ordering
            node.sim.step()
            stepped.add(nid)
            for t_inj, dst in self._drain_triggers(node):
                dnode = self.nodes[dst]
                if (dst != nid and dnode.alive
                        and t_inj <= self._node_lim(dnode, t)):
                    heapq.heappush(heap, (t_inj, dst))
            nxt = node.sim.peek_t()
            if nxt is not None and nxt <= self._node_lim(node, t):
                heapq.heappush(heap, (nxt, nid))
        return stepped

    def _drain_triggers(self, node: FleetNode) -> list[tuple[float, int]]:
        """Forward the node's exported cascade completions to the current
        hosts of their dependent stages.  Cross-node edges pay the
        activation transfer: the child frame arrives ``transfer_s`` later
        (deadline still anchored at the parent's completion, so the wire
        eats real slack) and the link energy is charged to the child's
        fleet UXCost entry.  Returns (injection time, node id) pairs for
        the interleave heap."""
        if not node.sim.pending_completions:
            return []
        pend = node.sim.pending_completions
        node.sim.pending_completions = []
        pushes: list[tuple[float, int]] = []
        for name, tc, origin, parent_uid in pend:
            key = self._name_stage.get(name)
            if key is None:
                continue
            sid, k = key
            sv = self.streams[sid]
            for ck, prob in sv.children_of(k):
                if not self._trigger_fires(sid, ck, prob):
                    continue
                dst = self.stage_node.get((sid, ck))
                if dst is None or not self.nodes[dst].alive:
                    continue
                t_inj = tc
                wire_s = 0.0
                if dst != node.node_id:
                    nbytes = sv.act_bytes_into(ck)
                    # shared-link realization: a trigger behind another
                    # transfer on the same node pair queues for the wire
                    xfer_s, xfer_j = self.links.transfer(
                        node.node_id, dst, nbytes, tc)
                    t_inj = tc + xfer_s
                    wire_s = xfer_s
                    self._charge(f"s{sid}." + sv.stage_base(ck), xfer_j)
                    self.trigger_transfers += 1
                    if self._tracer is not None:
                        self._tracer.span(
                            "xfer", tc, t_inj, stream=sid, stage=ck,
                            src=node.node_id, dst=dst, nbytes=nbytes,
                            xfer_s=xfer_s, xfer_j=xfer_j)
                    if self._metrics is not None:
                        self._m_trig.inc()
                # a freshly-migrated child serves nothing until its weight
                # state lands; early triggers queue until residency (the
                # deadline anchor stays at the parent completion, so the
                # wait eats real slack)
                t_inj = max(t_inj, self.stage_ready.get((sid, ck), t_inj))
                self.nodes[dst].sim.inject_arrival(
                    self.stage_name[(sid, ck)], t_inj, deadline_anchor=tc,
                    origin=origin, parent_uid=parent_uid, xfer_s=wire_s)
                pushes.append((t_inj, dst))
        return pushes

    def _trigger_fires(self, sid: int, ck: int, prob: float) -> bool:
        """Counter-based Bernoulli draw for cascade edge (sid -> stage ck):
        the n-th parent completion of an edge draws a keyed hash of
        (fleet seed, stream, edge, n), so the realized trigger sequence
        is a property of the *workload*, not of placement or event
        interleaving — whole-pipeline and stage-split runs of one scenario
        face identical cascade realizations, and replay needs no trace
        records for triggers."""
        n = self._trigger_counts.get((sid, ck), 0)
        self._trigger_counts[(sid, ck)] = n + 1
        return _hash_u01(self.seed, _TRIGGER_STREAM, sid, ck, n) < prob

    def _charge(self, canonical: str, joules: float) -> None:
        self.xfer_energy[canonical] = (self.xfer_energy.get(canonical, 0.0)
                                       + joules)

    def _candidates(self, exclude: Optional[int] = None) -> list[FleetNode]:
        # memoized per `exclude`: membership state only changes at
        # node_join/node_leave/node_drain, each of which clears the cache
        cands = self._cands_cache.get(exclude)
        if cands is None:
            cands = _CandidateList(
                self.nodes[nid] for nid in sorted(self.nodes)
                if self.nodes[nid].alive and not self.nodes[nid].draining
                and nid != exclude)
            cands._fleet = self
            self._cands_cache[exclude] = cands
        return cands

    def _tel_columns(self, cands: "_CandidateList") -> dict:
        """SoA telemetry columns for one candidate list: per-node arrays of
        the four fields batched placement scoring reads, plus the
        per-system node groups used to fill cost columns with one
        ``cost_on`` per distinct accelerator mix.  Values are copied out of
        the same memoized ``telemetry()`` snapshots the scalar path reads;
        only rows whose node fired the telemetry dirty hook are re-read."""
        cols = self._tel_cols
        if cols is None or cols["cands"] is not cands:
            groups: dict = {}
            for i, node in enumerate(cands):
                key = (node.system if node.system != "custom"
                       else ("node", node.node_id))
                groups.setdefault(key, (node, []))[1].append(i)
            n = len(cands)
            cols = {
                "cands": cands,
                "ids": np.array([nd.node_id for nd in cands],
                                dtype=np.int64),
                "row_of": {nd.node_id: i for i, nd in enumerate(cands)},
                "groups": [(nd, np.array(ix, dtype=np.intp))
                           for nd, ix in groups.values()],
                "offered_util": np.empty(n), "n_accs": np.empty(n),
                "backlog": np.empty(n), "dlv": np.empty(n),
            }
            for i, node in enumerate(cands):
                tel = node.telemetry()
                cols["offered_util"][i] = tel.offered_util
                cols["n_accs"][i] = tel.n_accs
                cols["backlog"][i] = tel.backlog_s
                cols["dlv"][i] = tel.window_dlv
            self._tel_cols = cols
            self._tel_dirty.clear()
            return cols
        if self._tel_dirty:
            row_of = cols["row_of"]
            for nid in self._tel_dirty:
                i = row_of.get(nid)
                if i is None:
                    continue
                tel = self.nodes[nid].telemetry()
                cols["offered_util"][i] = tel.offered_util
                cols["n_accs"][i] = tel.n_accs
                cols["backlog"][i] = tel.backlog_s
                cols["dlv"][i] = tel.window_dlv
            self._tel_dirty.clear()
        return cols

    # ------------------------------------------------ whole-stream placement
    def _place(self, sid: int, nid: int, t: float, gen: int) -> None:
        sv = self.streams[sid]
        specs, names = sv.namespaced_specs(gen)
        self.nodes[nid].place(sid, specs, names, t)
        self.stream_node[sid] = nid
        self.gen[sid] = gen
        self._stream_t0.setdefault(sid, t)
        if self._tracer is not None:
            self._tracer.event("place", t, stream=sid, node=nid, gen=gen)
        if self._metrics is not None:
            self._m_place.inc(node=nid)
            self._m_streams.set(len(self._stream_t0))
        # re-materialize the stream's SLO ladder level on the (possibly
        # new) host: every re-placement mints generation-fresh names, so
        # the variant pin must follow the stream.  No-op for streams the
        # controller never touched (the bit-identical inert path).
        level = self.slo_level.get(sid)
        if level is not None:
            self.nodes[nid].swap_level(names, level, t)
        self._touch(nid)

    def _migrate(self, sid: int, src: int, dst: int, t: float,
                 gen: int) -> tuple[Optional[float], Optional[float]]:
        """Move a whole stream; returns the (latency, energy) charged, or
        (None, None) when no transfer model is active."""
        self.nodes[src].evict(sid, t)
        xfer_s = xfer_j = None
        t_place = t
        if self.transfer is not None:
            sv = self.streams[sid]
            total = sum(sv.state_bytes(k) for k in range(sv.n_stages))
            if self.transfer.enabled:
                xfer_s, xfer_j = self.links.transfer(src, dst, total, t)
            else:
                # air-gapped: weights reload from node-local storage
                xfer_s, xfer_j = 0.0, self.transfer.transfer_j(total)
            t_place = t + xfer_s
            for k in range(sv.n_stages):
                self._charge(f"s{sid}." + sv.stage_base(k),
                             self.transfer.transfer_j(sv.state_bytes(k)))
        self._place(sid, dst, t_place, gen)
        self.migrations += 1
        if self._tracer is not None:
            self._tracer.span("migrate", t, t_place, stream=sid, src=src,
                              dst=dst, gen=gen, xfer_s=xfer_s,
                              xfer_j=xfer_j)
        if self._metrics is not None:
            self._m_migr.inc(src=src, dst=dst)
        return xfer_s, xfer_j

    # ------------------------------------------------ stage-split placement
    def _place_stage(self, sid: int, k: int, nid: int, t: float,
                     gen: int) -> None:
        sv = self.streams[sid]
        spec, name = sv.stage_spec(k, gen)
        node = self.nodes[nid]
        w = (1.0 if sv.parent_of(k) is None
             else sv.entries[k].trigger_prob)
        node.place((sid, k), [spec], [name], t, weights=[w])
        if sv.children_of(k):
            # parent stages report completions so the fleet can forward
            # cascade triggers (same-node edges included)
            node.sim.export_completions.add(name)
        self.stage_node[(sid, k)] = nid
        self.stage_gen[(sid, k)] = gen
        self.stage_name[(sid, k)] = name
        self.stage_ready[(sid, k)] = t   # migrations pass t + transfer_s
        self._name_stage[name] = (sid, k)
        self._stream_t0.setdefault(sid, t)
        if self._tracer is not None:
            self._tracer.event("place", t, stream=sid, stage=k, node=nid,
                               gen=gen)
        if self._metrics is not None:
            self._m_place.inc(node=nid)
            self._m_streams.set(len(self._stream_t0))
        # the SLO variant pin follows the stage across re-placements (see
        # _place); stage granularity, so sibling stages are untouched
        level = self.slo_level.get(sid)
        if level is not None:
            node.swap_level([name], level, t)
        self._touch(nid)

    def _migrate_stage(self, sid: int, k: int, src: int, dst: int, t: float,
                       gen: int) -> tuple[float, float]:
        """Move one stage; returns the (latency, energy) charged.  The
        re-placement is delayed by the state-transfer latency; with a
        zero-bandwidth link the state reloads from node-local storage
        instead (energy only, no wire delay)."""
        self.nodes[src].evict((sid, k), t)
        sv = self.streams[sid]
        nbytes = sv.state_bytes(k)
        if self.transfer.enabled:
            xfer_s, xfer_j = self.links.transfer(src, dst, nbytes, t)
        else:
            xfer_s, xfer_j = 0.0, self.transfer.transfer_j(nbytes)
        self._charge(f"s{sid}." + sv.stage_base(k), xfer_j)
        self._place_stage(sid, k, dst, t + xfer_s, gen)
        self.migrations += 1
        self.stage_migrations += 1
        if self._tracer is not None:
            self._tracer.span("migrate", t, t + xfer_s, stream=sid,
                              stage=k, src=src, dst=dst, gen=gen,
                              xfer_s=xfer_s, xfer_j=xfer_j)
        if self._metrics is not None:
            self._m_migr.inc(src=src, dst=dst)
        return xfer_s, xfer_j

    def _stage_score_full(self, sid: int, k: int, node: FleetNode,
                          best_iso: float) -> float:
        """Stage score including *all* cascade edges the placement would
        cut: the parent edge (via the router) plus edges to already-placed
        children — so a head cannot drift away from its children for free
        during drains and rebalances.  Edges to stages on draining or dead
        nodes are ignored: those stages must move regardless, and pricing
        them (infinitely, under zero bandwidth) would otherwise make every
        candidate look equally bad and collapse the argmin onto the lowest
        node id."""
        sv = self.streams[sid]
        p = sv.parent_of(k)
        parent_nid = self.stage_node.get((sid, p)) if p is not None else None
        if parent_nid is not None:
            pn = self.nodes[parent_nid]
            if not pn.alive or pn.draining:
                parent_nid = None
        s = self.policy.stage_score(sv, k, node, best_iso, parent_nid,
                                    self.transfer)
        for ck, _prob in sv.children_of(k):
            cn = self.stage_node.get((sid, ck))
            if cn is None or cn == node.node_id:
                continue
            cnode = self.nodes[cn]
            if not cnode.alive or cnode.draining:
                continue
            s += self.policy.transfer_penalty(sv, ck, self.transfer)
        return s

    def _pick_stage_dst(self, sid: int, k: int,
                        cands: list[FleetNode]) -> int:
        """Destination for one migrating stage.  Non-splitting policies
        keep streams co-located: a stage follows its (already re-placed)
        parent, and heads re-run whole-stream placement — so the
        ``score_whole`` control arm and round-robin/least-loaded fleets
        never split a pipeline through churn.  Splitting policies re-score
        the stage with all its cascade edges."""
        sv = self.streams[sid]
        if not getattr(self.policy, "splits_stages", False):
            p = sv.parent_of(k)
            if p is not None:
                pn = self.stage_node.get((sid, p))
                if pn is not None and any(n.node_id == pn for n in cands):
                    return pn
            return self.policy.place(sv, cands)
        best_iso = min(sv.stage_cost_on(n, k).iso_s for n in cands)
        return argmin_node(
            cands, lambda n: self._stage_score_full(sid, k, n, best_iso))

    # ------------------------------------------------------ event handlers
    def _rearm_tuner(self) -> None:
        """Membership churn / phase events re-arm the fleet weight tuner
        (live runs only: replay installs recorded weights instead) — the
        fleet-level mirror of each node's ``retrigger_probe``."""
        rearm = getattr(self.policy, "rearm", None)
        if self.replay is None and rearm is not None:
            rearm()
            self.tuner_retriggers += 1

    def _on_node_join(self, t: float, ev: dict) -> None:
        nid, system = int(ev["node"]), ev["system"]
        if nid in self.nodes:
            raise ValueError(f"node {nid} joined twice")
        ns = node_seed(self.seed, nid)
        self.nodes[nid] = FleetNode(
            nid, system, self.scheduler_factory(ns),
            duration_s=self.duration_s, seed=ns,
            window_s=self.window_s, at_t=t,
            genai_predictor=self.genai_predictor, engine=self.engine,
            obs=self.obs)
        self.nodes[nid].tel_dirty_hook = self._tel_dirty.add
        self._cands_cache.clear()
        if self.recorder is not None:
            self.recorder.node_join(t, nid, system)
        self._touch(nid)
        if self._tracer is not None:
            self._tracer.event("node_join", t, node=nid, system=str(system))
        self._rearm_tuner()

    def _on_node_leave(self, t: float, ev: dict) -> None:
        node = self.nodes[int(ev["node"])]
        if self.recorder is not None:
            self.recorder.node_leave(t, node.node_id)
        if self.replay is None:
            self._migrate_all_off(node, t)
        node.alive = False
        self._cands_cache.clear()
        if self._tracer is not None:
            self._tracer.event("node_leave", t, node=node.node_id)
        self._rearm_tuner()

    def _on_node_drain(self, t: float, ev: dict) -> None:
        node = self.nodes[int(ev["node"])]
        if self.recorder is not None:
            self.recorder.node_drain(t, node.node_id)
        node.draining = True
        self._cands_cache.clear()
        node._invalidate_telemetry()
        if self.replay is None:
            self._migrate_all_off(node, t)
        if self._tracer is not None:
            self._tracer.event("node_drain", t, node=node.node_id)
        self._rearm_tuner()

    def _on_phase(self, t: float, ev: dict) -> None:
        """Fleet-level phase event: forward the (stream-addressed) action
        to every targeted stream's hosting node(s) as a node-local phase
        action on its namespaced model names.  Runs identically live and
        in replay — placements at time ``t`` are identical, so the
        forwarded node-local actions are too.  Streams that have not
        arrived yet are skipped (a phase cannot retarget the future); the
        touched nodes' (alpha, beta) probes re-arm, and so does the fleet
        weight tuner."""
        action_cfg = dict(ev["action"])
        sids = ev.get("sids")
        targets = (sorted(self.streams) if sids is None
                   else [int(s) for s in sids])
        for sid in targets:
            sv = self.streams.get(sid)
            if sv is None or sid in self.departed or sid in self.rejected:
                # a phase cannot retarget the future (stream not arrived)
                # or the absent (departed; it rejoins at its last-seen
                # definition — and a rejected stream is not serving, so
                # there is nothing to mutate) — identical live and in
                # replay, since rejections are replayed as inputs
                continue
            by_node: dict[int, list[str]] = {}
            if self.split:
                for k in range(sv.n_stages):
                    nid = self.stage_node.get((sid, k))
                    if nid is not None:
                        by_node.setdefault(nid, []).append(
                            self.stage_name[(sid, k)])
            else:
                nid = self.stream_node.get(sid)
                if nid is not None:
                    by_node[nid] = list(self.nodes[nid].placements.get(
                        sid, ()))
            for nid in sorted(by_node):
                node = self.nodes[nid]
                if not node.alive or not by_node[nid]:
                    continue
                node.sim.apply_action(
                    PhaseAction.from_config(
                        dict(action_cfg, models=by_node[nid])), t)
                node._recompute_offered()
                node.retrigger_probe()
                self._touch(nid)
            if action_cfg["kind"] == "scale_fps":
                # keep the stream's own definition in sync so later
                # migrations re-place at the shifted rate
                sv.rescale_fps(float(action_cfg["factor"]))
        if self.recorder is not None:
            self.recorder.phase(t, action_cfg, sids)
        self._rearm_tuner()

    def _on_tune(self, t: float, ev: dict) -> None:
        """Live: a synthetic tune tick — close a telemetry window and feed
        it to the weight tuner, recording the committed weights.  Replay: a
        recorded tuner decision — install the weights directly, bypassing
        telemetry and probe entirely."""
        if self.replay is not None:
            set_weights = getattr(self.policy, "set_weights", None)
            if set_weights is not None:
                set_weights(ev["weights"])
            return
        win = self.telemetry.observe(t, self.nodes, self.migrations,
                                     sum(self.xfer_energy.values()),
                                     departures=self.departures,
                                     rejections=self.rejections,
                                     swaps=self.swaps)
        if self._tracer is not None:
            self._tracer.event("tune", t, uxcost=win.uxcost,
                               frames=win.frames, dlv=win.dlv_rate,
                               backlog_p90=win.backlog_p90)
        if self._metrics is not None:
            g = self._metrics.gauge(
                "fleet_window_uxcost", "UXCost of the last tuner window")
            g.set(win.uxcost)
            self._metrics.gauge(
                "fleet_window_dlv_rate",
                "DLV rate of the last tuner window").set(win.dlv_rate)
        on_window = getattr(self.policy, "on_window", None)
        if on_window is None:
            return                      # telemetry-only tick
        weights = on_window(win, self._tuner_rng)
        if weights is not None and self.recorder is not None:
            self.recorder.tune(t, list(weights), window_uxcost=win.uxcost,
                               probing=self.policy.probe.probing)

    def _migrate_all_off(self, node: FleetNode, t: float) -> None:
        for key in sorted(node.placements):
            cands = self._candidates(exclude=node.node_id)
            if not cands:
                raise RuntimeError(
                    f"no live nodes left to host {key} at t={t}")
            if self.split:
                sid, k = key
                dst = self._pick_stage_dst(sid, k, cands)
                gen = self.stage_gen[(sid, k)] + 1
                xfer_s, xfer_j = self._migrate_stage(
                    sid, k, node.node_id, dst, t, gen)
                if self.recorder is not None:
                    self.recorder.migrate(t, sid, node.node_id, dst, gen,
                                          stage=k, xfer_s=xfer_s,
                                          xfer_j=xfer_j)
            else:
                sid = key
                dst = self.policy.place(self.streams[sid], cands)
                gen = self.gen[sid] + 1
                xfer_s, xfer_j = self._migrate(sid, node.node_id, dst, t,
                                               gen)
                if self.recorder is not None:
                    self.recorder.migrate(t, sid, node.node_id, dst, gen,
                                          xfer_s=xfer_s, xfer_j=xfer_j)

    # ------------------------------------------------------ SLO subsystem
    def _ladder_depth(self, sid: int) -> int:
        """Degradation-ladder depth of a stream: the deepest supernet
        variant ladder over its stages (0 = no variants, nothing to swap)."""
        d = self._ladder_cache.get(sid)
        if d is None:
            sv = self.streams[sid]
            d = max((len(sv.stage_graph(k).variants)
                     for k in range(sv.n_stages)), default=0)
            self._ladder_cache[sid] = d
        return d

    def _live_utils(self, cands: list[FleetNode]) -> list[float]:
        """Per-candidate offered utilization right now — the U(t) input of
        the admission law."""
        return [n.offered_s / len(n.sim.accs) for n in cands]

    def _apply_level(self, sid: int, t: float) -> None:
        """Materialize stream ``sid``'s current ladder level on its hosting
        node(s).  Streams the controller never touched return immediately,
        keeping the controller-free path bit-identical to pre-SLO runs."""
        level = self.slo_level.get(sid)
        if level is None:
            return
        sv = self.streams[sid]
        if self.split:
            for k in range(sv.n_stages):
                nid = self.stage_node.get((sid, k))
                if nid is not None and self.nodes[nid].alive:
                    self.nodes[nid].swap_level(
                        [self.stage_name[(sid, k)]], level, t)
        else:
            nid = self.stream_node.get(sid)
            if nid is not None and self.nodes[nid].alive:
                names = list(self.nodes[nid].placements.get(sid, ()))
                if names:
                    self.nodes[nid].swap_level(names, level, t)

    def _apply_level_change(self, sid: int, level: int, t: float) -> None:
        """One degradation-ladder move (live decision or replayed ``swap``
        record): update the level, swap the hosted variants, re-arm the
        fleet tuner — a quality change shifts offered load, which is as
        much a workload change as churn is."""
        prev = self.slo_level.get(sid, 0)
        if level == prev:
            return
        self.swaps += 1
        if level < prev:
            self.promotions += 1
        self.slo_level[sid] = level
        self._apply_level(sid, t)
        if self._tracer is not None:
            self._tracer.event(
                "swap", t, stream=sid, level=level, prev=prev,
                pressure=(self.slo.last_pressure
                          if self.slo is not None else None),
                terms=(dict(self.slo.last_terms)
                       if self.slo is not None else None))
        if self._metrics is not None:
            self._m_swap.inc(
                direction="promote" if level < prev else "degrade")
        self._rearm_tuner()

    def _reject_stream(self, t: float, sid: int) -> None:
        """Refuse a stream admission (live verdict or replayed ``reject``
        record): no placement happens; the refused head frames accrue as
        deadline violations until the stream departs (or the run ends), so
        a rejection is a first-class UXCost outcome, never a silent drop."""
        sv = self.streams[sid]
        self.rejected.add(sid)
        self._reject_open[sid] = (t, sv.entries[0].fps)
        self.rejections += 1
        tier = self.stream_slo.get(sid, DEFAULT_SLO).tier
        if self.recorder is not None:
            self.recorder.reject(t, sid, tier,
                                 pressure=self.slo.last_pressure
                                 if self.slo is not None else None)
        if self._tracer is not None:
            self._tracer.event(
                "reject", t, stream=sid, tier=tier,
                pressure=(self.slo.last_pressure
                          if self.slo is not None else None),
                terms=(dict(self.slo.last_terms)
                       if self.slo is not None else None))
        if self._metrics is not None:
            self._m_rej.inc(tier=tier)

    def _close_reject(self, sid: int, t: float) -> None:
        t0_fps = self._reject_open.pop(sid, None)
        if t0_fps is None:
            return
        t0, fps = t0_fps
        t1 = min(t, self.duration_s)
        if t1 > t0:
            self._reject_frames[sid] = (self._reject_frames.get(sid, 0.0)
                                        + (t1 - t0) * fps)

    def _on_swap(self, t: float, ev: dict) -> None:      # replay only
        self._apply_level_change(int(ev["sid"]), int(ev["level"]), t)

    def _on_reject(self, t: float, ev: dict) -> None:    # replay only
        self._reject_stream(t, int(ev["sid"]))

    def _on_slo_tick(self, t: float, ev: dict) -> None:  # live only
        """Controller tick: close an SLO telemetry window, update the
        pressure, and walk the degradation ladder — degrade the weakest
        placed streams under sustained pressure, promote them back (one
        level per tick) once pressure clears the hysteresis band."""
        cands = self._candidates()
        win = self._slo_tel.observe(t, self.nodes, self.migrations,
                                    sum(self.xfer_energy.values()),
                                    departures=self.departures,
                                    rejections=self.rejections,
                                    swaps=self.swaps)
        self.slo.on_window(win, self._live_utils(cands))
        if self._tracer is not None:
            self._tracer.event("slo_tick", t,
                               pressure=self.slo.last_pressure,
                               terms=dict(self.slo.last_terms),
                               streams=len(self.streams)
                               - len(self.departed) - len(self.rejected))
        states = []
        for sid in sorted(self.streams):
            if sid in self.departed or sid in self.rejected:
                continue
            depth = self._ladder_depth(sid)
            if depth == 0:
                continue
            slo = self.stream_slo.get(sid, DEFAULT_SLO)
            # local pressure: the hosting node's window DLV (max across
            # stages for split placements) — the ladder degrades victims
            # on the hottest nodes first, where the swap relieves the
            # pressured tier-0 neighbours
            if self.split:
                nids = [self.stage_node.get((sid, k))
                        for k in range(self.streams[sid].n_stages)]
            else:
                nids = [self.stream_node.get(sid)]
            load = max((win.node_dlv.get(nid, 0.0)
                        for nid in nids if nid is not None), default=0.0)
            states.append(StreamState(
                sid=sid, tier=slo.tier, priority=slo.priority,
                level=self.slo_level.get(sid, 0), max_level=depth,
                load=load))
        for sid, level in self.slo.plan(states):
            self._apply_level_change(sid, level, t)
            if self.recorder is not None:
                self.recorder.swap(t, sid, level,
                                   pressure=self.slo.last_pressure)

    def _on_stream(self, t: float, ev: dict) -> None:
        sid = int(ev["sid"])
        self.streams[sid] = StreamView(sid, ev["entries"])
        slo_cfg = ev.get("slo")
        if slo_cfg is not None:
            self.stream_slo[sid] = slo_from_config(slo_cfg)
            self.streams[sid].budget_factor = \
                self.stream_slo[sid].budget_factor
        if self._tracer is not None:
            self._tracer.event("stream", t, stream=sid,
                               stages=self.streams[sid].n_stages)
        if self.recorder is not None:
            self.recorder.stream(t, sid, ev["entries"], slo=slo_cfg)
        if self.replay is not None:
            return                       # recorded `place` events follow
        cands = self._candidates()
        if not cands:
            raise RuntimeError(f"stream {sid} arrived with no live nodes")
        sv = self.streams[sid]
        level = 0
        if self.slo is not None:
            slo = self.stream_slo.get(sid, DEFAULT_SLO)
            self.slo.register(sid, slo, sv.head_period_s)
            verdict, level = self.slo.admit(
                slo, self._ladder_depth(sid), self._live_utils(cands))
            if self._tracer is not None:
                self._tracer.event("admit", t, stream=sid, tier=slo.tier,
                                   verdict=verdict, level=level,
                                   pressure=self.slo.last_pressure,
                                   terms=dict(self.slo.last_terms))
            if verdict == "reject":
                self._reject_stream(t, sid)
                return
        if level > 0:
            # degraded admission: the level is set (and the swap recorded)
            # BEFORE placement so the trailing re-pin in _place applies the
            # variant ahead of the stream's first frame — replay interleaves
            # a node advance between the place and any later record, so a
            # swap recorded after placement would miss same-time arrivals
            self._apply_level_change(sid, level, t)
            if self.recorder is not None:
                self.recorder.swap(t, sid, level,
                                   pressure=self.slo.last_pressure)
        if self.split:
            nids = self.policy.place_stages(sv, cands, self.transfer)
            for k, nid in enumerate(nids):
                self._place_stage(sid, k, nid, t, gen=0)
                if self.recorder is not None:
                    self.recorder.place(t, sid, nid, 0, stage=k)
        else:
            nid = self.policy.place(sv, cands)
            self._place(sid, nid, t, gen=0)
            if self.recorder is not None:
                self.recorder.place(t, sid, nid, 0)

    def _on_depart(self, t: float, ev: dict) -> None:
        """Stream departure — the load-release half of task dynamicity.
        Runs identically live and in replay (placements at ``t`` are
        identical, so the eviction and purge are too): the stream is
        evicted from its hosting node(s), its queued-but-not-running
        frames are purged without counting against UXCost (the user
        walked away; jobs already executing finish and count), the
        touched nodes' (alpha, beta) probes re-arm via the eviction path,
        and the fleet weight tuner re-arms — less offered load is as much
        a workload change as more."""
        sid = int(ev["sid"])
        sv = self.streams.get(sid)
        if sv is None or sid in self.departed:
            raise ValueError(f"depart of stream {sid} at t={t}: stream "
                             "is not present (bad scenario or trace)")
        if sid in self.rejected:
            # a refused stream departing closes its rejection span: frames
            # it would have offered stop accruing as violations
            self.rejected.discard(sid)
            self._close_reject(sid, t)
        if self.slo is not None:
            self.slo.forget(sid)
        purged = 0
        if self.split:
            for k in range(sv.n_stages):
                nid = self.stage_node.pop((sid, k), None)
                if nid is not None and self.nodes[nid].alive:
                    purged += self.nodes[nid].release((sid, k), t)
                self.stage_ready.pop((sid, k), None)
        else:
            nid = self.stream_node.pop(sid, None)
            if nid is not None and self.nodes[nid].alive:
                purged += self.nodes[nid].release(sid, t)
        self.departed.add(sid)
        self.departures += 1
        self.jobs_purged += purged
        # stream-seconds accounting is obs-independent: the benchmark's
        # streams_per_wall_s throughput figure needs it with obs disabled
        t0 = self._stream_t0.pop(sid, None)
        if t0 is not None:
            self.stream_seconds += max(0.0, min(t, self.duration_s) - t0)
        if self._tracer is not None:
            self._tracer.event("depart", t, stream=sid, purged=purged)
        if self._m_streams is not None:
            self._m_streams.set(len(self._stream_t0))
        if self.recorder is not None:
            self.recorder.depart(t, sid, purged)
        self._rearm_tuner()

    def _on_rejoin(self, t: float, ev: dict) -> None:
        """A departed stream returns: the router re-places its recorded
        pipeline definition under a fresh placement generation, exactly
        like a new arrival (replay: the recorded ``place`` events
        follow).  The sudden load is a workload change, so the fleet
        tuner re-arms here too."""
        sid = int(ev["sid"])
        if sid not in self.departed:
            raise ValueError(f"rejoin of stream {sid} at t={t} without a "
                             "preceding depart (bad scenario or trace)")
        self.departed.discard(sid)
        self.rejoins += 1
        if self._tracer is not None:
            self._tracer.event("rejoin", t, stream=sid)
        if self.recorder is not None:
            self.recorder.rejoin(t, sid)
        self._rearm_tuner()
        if self.replay is not None:
            return                       # recorded `place` events follow
        cands = self._candidates()
        if not cands:
            raise RuntimeError(f"stream {sid} rejoined with no live nodes")
        sv = self.streams[sid]
        level = 0
        if self.slo is not None:
            # a rejoin is an arrival for admission purposes: the returning
            # load faces the same gate (and may be refused again)
            slo = self.stream_slo.get(sid, DEFAULT_SLO)
            self.slo.register(sid, slo, sv.head_period_s)
            verdict, level = self.slo.admit(
                slo, self._ladder_depth(sid), self._live_utils(cands))
            if self._tracer is not None:
                self._tracer.event("admit", t, stream=sid, tier=slo.tier,
                                   verdict=verdict, level=level,
                                   pressure=self.slo.last_pressure,
                                   terms=dict(self.slo.last_terms))
            if verdict == "reject":
                self._reject_stream(t, sid)
                return
        if level > 0:
            # swap-before-place, for the same replay-ordering reason as at
            # first arrival (see _on_stream)
            self._apply_level_change(sid, level, t)
            if self.recorder is not None:
                self.recorder.swap(t, sid, level,
                                   pressure=self.slo.last_pressure)
        if self.split:
            nids = self.policy.place_stages(sv, cands, self.transfer)
            for k, nid in enumerate(nids):
                gen = self.stage_gen.get((sid, k), -1) + 1
                self._place_stage(sid, k, nid, t, gen=gen)
                if self.recorder is not None:
                    self.recorder.place(t, sid, nid, gen, stage=k)
        else:
            nid = self.policy.place(sv, cands)
            gen = self.gen.get(sid, -1) + 1
            self._place(sid, nid, t, gen=gen)
            if self.recorder is not None:
                self.recorder.place(t, sid, nid, gen)

    def _on_place(self, t: float, ev: dict) -> None:       # replay only
        if "stage" in ev:
            self._place_stage(int(ev["sid"]), int(ev["stage"]),
                              int(ev["node"]), t, int(ev["gen"]))
        else:
            self._place(int(ev["sid"]), int(ev["node"]), t, int(ev["gen"]))

    def _on_migrate(self, t: float, ev: dict) -> None:     # replay only
        if "stage" in ev:
            self._migrate_stage(int(ev["sid"]), int(ev["stage"]),
                                int(ev["from"]), int(ev["to"]), t,
                                int(ev["gen"]))
        else:
            self._migrate(int(ev["sid"]), int(ev["from"]), int(ev["to"]), t,
                          int(ev["gen"]))

    def _on_rebalance(self, t: float, ev: dict) -> None:   # live only
        """Optional phase-boundary re-placement: move a stream (or, in
        stage-split mode, a single stage) when the score-driven router now
        prefers another node by a clear margin."""
        if not isinstance(self.policy, ScoreDrivenRouter):
            return
        cands = self._candidates()          # membership is fixed in-tick
        if len(cands) < 2:
            return
        if self.split:
            # each policy rebalances at its own placement granularity:
            # splitting policies move single stages, non-splitting ones
            # move whole co-located streams — so control arms correct
            # placement mistakes too, just never by splitting a pipeline
            if getattr(self.policy, "splits_stages", False):
                self._rebalance_stages(t, cands)
            else:
                self._rebalance_streams_whole(t, cands)
            return
        for sid in sorted(self.stream_node):
            cur = self.stream_node[sid]
            if not self.nodes[cur].alive:
                continue
            sv = self.streams[sid]
            scores = self._score_map(sv, cands)
            best = min(scores, key=lambda nid: (scores[nid], nid))
            cur_score = scores.get(cur)
            if (best != cur and cur_score is not None
                    and cur_score - scores[best] > self.rebalance_hysteresis):
                gen = self.gen[sid] + 1
                xfer_s, xfer_j = self._migrate(sid, cur, best, t, gen)
                if self.recorder is not None:
                    self.recorder.migrate(t, sid, cur, best, gen,
                                          xfer_s=xfer_s, xfer_j=xfer_j)

    def _score_map(self, sv, cands: list[FleetNode]) -> dict[int, float]:
        """Whole-stream rebalance scores per candidate node — batched
        through :meth:`ScoreDrivenRouter.score_all` when the policy runs
        vectorized, per-node :meth:`~ScoreDrivenRouter.score` calls
        otherwise; both produce bit-identical values."""
        if getattr(self.policy, "vectorized", False):
            svec = self.policy.score_all(sv, cands)
            return {n.node_id: float(s) for n, s in zip(cands, svec)}
        best_iso = min(sv.cost_on(n).iso_s for n in cands)
        return {n.node_id: self.policy.score(sv, n, best_iso)
                for n in cands}

    def _rebalance_streams_whole(self, t: float,
                                 cands: list[FleetNode]) -> None:
        """Stage-mode rebalance for non-splitting policies: score whole
        streams and move every stage of a winner together (stages of such
        streams are co-located by invariant, so one source node hosts
        them all)."""
        for sid in sorted(self.streams):
            if (sid, 0) not in self.stage_node:
                continue
            cur = self.stage_node[(sid, 0)]
            if not self.nodes[cur].alive or self.nodes[cur].draining:
                continue
            sv = self.streams[sid]
            scores = self._score_map(sv, cands)
            best = min(scores, key=lambda nid: (scores[nid], nid))
            cur_score = scores.get(cur)
            if (best == cur or cur_score is None
                    or cur_score - scores[best] <= self.rebalance_hysteresis):
                continue
            for k in range(sv.n_stages):
                gen = self.stage_gen[(sid, k)] + 1
                xfer_s, xfer_j = self._migrate_stage(sid, k, cur, best, t,
                                                     gen)
                if self.recorder is not None:
                    self.recorder.migrate(t, sid, cur, best, gen, stage=k,
                                          xfer_s=xfer_s, xfer_j=xfer_j)

    def _rebalance_stages(self, t: float, cands: list[FleetNode]) -> None:
        for (sid, k) in sorted(self.stage_node):
            cur = self.stage_node[(sid, k)]
            if not self.nodes[cur].alive or self.nodes[cur].draining:
                continue
            sv = self.streams[sid]
            best_iso = min(sv.stage_cost_on(n, k).iso_s for n in cands)
            scores: dict[int, float] = {
                n.node_id: self._stage_score_full(sid, k, n, best_iso)
                for n in cands}
            best = min(scores, key=lambda nid: (scores[nid], nid))
            cur_score = scores.get(cur)
            if (best != cur and cur_score is not None
                    and cur_score - scores[best] > self.rebalance_hysteresis):
                gen = self.stage_gen[(sid, k)] + 1
                xfer_s, xfer_j = self._migrate_stage(sid, k, cur, best, t,
                                                     gen)
                if self.recorder is not None:
                    self.recorder.migrate(t, sid, cur, best, gen, stage=k,
                                          xfer_s=xfer_s, xfer_j=xfer_j)

    # ----------------------------------------------------------------- run
    def _event_stream(self) -> list[tuple[float, str, dict]]:
        events = list(self._events)
        # synthetic tune ticks precede same-time rebalance ticks (appended
        # first; the sort below is stable), so a rebalance always runs
        # under the weights the tuner just committed
        if self.tune_every_s is not None:
            k = 1
            while k * self.tune_every_s < self.duration_s:
                events.append((k * self.tune_every_s, "tune", {"k": k}))
                k += 1
        # SLO controller ticks follow same-time tune ticks (fresh tuner
        # weights first) and precede same-time rebalance ticks (a stream
        # degrades before it is considered for migration)
        if self.slo is not None and self.slo_every_s is not None:
            k = 1
            while k * self.slo_every_s < self.duration_s:
                events.append((k * self.slo_every_s, "slo", {"k": k}))
                k += 1
        if self.rebalance_every_s is not None:
            k = 1
            while k * self.rebalance_every_s < self.duration_s:
                events.append((k * self.rebalance_every_s,
                               "rebalance", {"k": k}))
                k += 1
        # stable sort keeps same-time events in declaration/record order;
        # synthetic ticks land after same-time scenario events
        return sorted(events, key=lambda e: e[0])

    def run(self) -> FleetResult:
        handlers = {
            "node_join": self._on_node_join,
            "node_leave": self._on_node_leave,
            "node_drain": self._on_node_drain,
            "stream": self._on_stream,
            "depart": self._on_depart,
            "rejoin": self._on_rejoin,
            "place": self._on_place,
            "migrate": self._on_migrate,
            "rebalance": self._on_rebalance,
            "phase": self._on_phase,
            "tune": self._on_tune,
            "slo": self._on_slo_tick,
            "swap": self._on_swap,
            "reject": self._on_reject,
        }
        prof = self._profiler
        if prof is not None:
            prof.start_run()
        try:
            for t, kind, ev in self._event_stream():
                if t > self.duration_s:
                    break
                self._advance_all(t)
                if prof is None:
                    handlers[kind](t, ev)
                else:
                    w0 = prof.t0()
                    handlers[kind](t, ev)
                    prof.add("fleet." + kind, w0)
            self._advance_all(self.duration_s)
        finally:
            if prof is not None:
                prof.stop_run()
        return self._finalize()

    def _finalize(self) -> FleetResult:
        fleet_stats = WindowStats()
        per_node: list[dict] = []
        frames = drops = retriggers = 0
        for nid in sorted(self.nodes):
            node = self.nodes[nid]
            r = node.finalize()
            for name, st in r.stats.per_model.items():
                fleet_stats.model(canonical_stream_model(name)).merge(st)
            frames += r.frames
            drops += r.drops
            retriggers += node.probe_retriggers
            # busy fraction since the node's join (SimResult utilization
            # divides by absolute time, understating mid-run joiners);
            # clamped because an abrupt leave can freeze sim.t with a
            # dispatch reservation still counted in busy_time
            span = max(node.sim.t - node.join_t, 1e-9)
            util = min(sum(a.busy_time for a in node.sim.accs)
                       / (len(node.sim.accs) * span), 1.0)
            per_node.append({
                "node": nid, "system": node.system, "alive": node.alive,
                "draining": node.draining, "frames": r.frames,
                "drops": r.drops, "uxcost": r.uxcost,
                "utilization": util, "streams": len(node.placements),
                "probe_retriggers": node.probe_retriggers,
            })
        # transfer energy (cross-node triggers + migrations) joins the moved
        # model's UXCost entry: NormEnergy rises, so moving state is never
        # free — charged exactly once per transfer, at transfer time.  A
        # model that completed zero frames has no worst-case normalizer
        # (NormEnergy ratio would discard the charge), so its charges
        # redirect to a same-stream entry that did complete frames; only a
        # stream with no completed frames at all leaves its (reported, but
        # unnormalizable) transfer energy out of the UXCost product
        for name in sorted(self.xfer_energy):
            st = fleet_stats.per_model.get(name)
            target = name
            if st is None or st.worst_energy_j <= 0.0:
                prefix = name.split(".", 1)[0] + "."
                cands = sorted(
                    n for n, s2 in fleet_stats.per_model.items()
                    if n.startswith(prefix) and s2.worst_energy_j > 0.0)
                if cands:
                    target = cands[0]
            fleet_stats.model(target).energy_j += self.xfer_energy[name]
        # rejection accounting: every head frame a refused stream would
        # have offered while rejected counts as a deadline violation (a
        # pseudo model entry with zero energy: RateDLV contributes 1.0,
        # NormEnergy nothing) — overload is *managed*, never free
        for sid in sorted(self._reject_open):
            self._close_reject(sid, self.duration_s)
        self._reject_open.clear()
        reject_frames = 0
        for sid in sorted(self._reject_frames):
            sv = self.streams[sid]
            n = max(1, int(round(self._reject_frames[sid])))
            st = fleet_stats.model(f"s{sid}." + sv.stage_base(0))
            st.frames += n
            st.violated += n
            reject_frames += n
        # per-tier breakdown (tierless streams are tier-1 "standard"):
        # the overload gate asserts tier-0 stays flat while lower tiers
        # absorb the degradation
        tier_frames: dict[int, int] = {}
        tier_viol: dict[int, int] = {}
        for name, st in fleet_stats.per_model.items():
            dot = name.find(".")
            if not name.startswith("s") or dot < 2:
                continue
            try:
                sid = int(name[1:dot])
            except ValueError:
                continue
            slo = self.stream_slo.get(sid, DEFAULT_SLO)
            tier_frames[slo.tier] = tier_frames.get(slo.tier, 0) + st.frames
            tier_viol[slo.tier] = tier_viol.get(slo.tier, 0) + st.violated
        tier_dlv = {tr: (tier_viol[tr] / tier_frames[tr]
                         if tier_frames[tr] else 0.0)
                    for tr in sorted(tier_frames)}
        # streams still placed at the horizon served until duration_s
        for sid in sorted(self._stream_t0):
            self.stream_seconds += max(
                0.0, self.duration_s - self._stream_t0[sid])
        self._stream_t0.clear()
        if self._tracer is not None:
            self._tracer.finish(self.duration_s)
        if self._metrics is not None:
            ux = uxcost(fleet_stats)
            self._metrics.gauge(
                "fleet_uxcost", "fleet UXCost at run end").set(ux)
            self._metrics.gauge(
                "fleet_dlv_rate", "fleet DLV rate at run end").set(
                overall_dlv_rate(fleet_stats))
            tf = self._metrics.gauge(
                "fleet_tier_frames_total", "frames per SLO tier", ("tier",))
            td = self._metrics.gauge(
                "fleet_tier_dlv_rate", "DLV rate per SLO tier", ("tier",))
            for tr in sorted(tier_frames):
                tf.set(tier_frames[tr], tier=tr)
                td.set(tier_dlv[tr], tier=tr)
        if self.recorder is not None:
            self.trace = self.recorder.trace()
        return FleetResult(
            name=self.name,
            policy=self.policy.name,
            duration_s=self.duration_s,
            n_nodes=len(self.nodes),
            n_streams=len(self.streams),
            stats=fleet_stats,
            uxcost=uxcost(fleet_stats),
            dlv_rate=overall_dlv_rate(fleet_stats),
            norm_energy=overall_norm_energy(fleet_stats),
            frames=frames,
            drops=drops,
            migrations=self.migrations,
            probe_retriggers=retriggers,
            per_node=per_node,
            trace=self.trace,
            split=self.split,
            stage_migrations=self.stage_migrations,
            trigger_transfers=self.trigger_transfers,
            xfer_energy_j=sum(self.xfer_energy.values()),
            weights=getattr(self.policy, "weights", None),
            tuner_windows=getattr(self.policy, "windows_seen", 0),
            tuner_commits=getattr(
                getattr(self.policy, "probe", None), "commits", 0),
            tuner_retriggers=self.tuner_retriggers,
            pipeline_latency_s=overall_pipeline_latency(fleet_stats),
            pipe_frames=sum(st.pipe_frames
                            for st in fleet_stats.per_model.values()),
            departures=self.departures,
            rejoins=self.rejoins,
            jobs_purged=self.jobs_purged,
            link_transfers=(self.links.n_transfers if self.links else 0),
            link_queued=(self.links.n_queued if self.links else 0),
            link_wait_s=(self.links.queued_s if self.links else 0.0),
            slo_enabled=(self.slo is not None
                         or (self.replay is not None
                             and "slo" in self.replay.meta)),
            rejections=self.rejections,
            swaps=self.swaps,
            promotions=self.promotions,
            reject_frames=reject_frames,
            tier_frames=dict(sorted(tier_frames.items())),
            tier_dlv=tier_dlv,
            stream_seconds=self.stream_seconds,
        )


def run_fleet(scenario: FleetScenario, policy: "str | RouterPolicy",
              duration_s: float = 4.0, seed: int = 0,
              **kw) -> FleetResult:
    return FleetSimulator(scenario, policy, duration_s=duration_s,
                          seed=seed, **kw).run()
