"""One DREAM node inside a fleet, and the surface the global router reads
of any node (copy of ``repro/cluster/node.py``).

A :class:`FleetNode` wraps an *empty-scenario*
``repro_torch.core.Simulator`` (streams arrive later, placed by the router
through ``Simulator.join_model``) driven through the step/peek API so the
fleet clock can interleave nodes.  Telemetry is a cheap snapshot — queue
depth, backlog, the latest UXCost window, utilization — and the
MapScore-style cross-node summaries (how well a candidate stream's models
suit this node's accelerator mix, and how much utilization it would add)
come from the memoized offline cost tables, so evaluating a stream against
every node of a 16-node fleet costs a handful of dict lookups.

The router types its nodes against :class:`RoutableNode`, the narrow
surface it reads: a ``node_id`` and a ``telemetry()`` snapshot. A stream's
cost on a node comes from the stream (``stream.cost_on(node)``), so any
object with these two members can be routed: a :class:`FleetNode` (which
also carries ``system``) or a live serving engine
(``repro_torch.launch.serve_fleet.EngineNode``).

Invariants:

  * placement keys are opaque to the node (the fleet passes stream ids or
    (sid, stage) tuples) and homogeneous within one run;
  * every placement/eviction re-arms the node's (alpha, beta) adaptivity
    probe (``retrigger_probe``) — churn is a workload change by definition;
  * ``offered_s`` tracks the summed offered load of *currently placed*
    streams under the weights the fleet supplied at placement time, so
    whole-stream and stage-split runs report comparable utilization;
  * ``recent_dlv`` covers only the latest advance span — a node is not
    penalized forever for early violations;
  * telemetry is a pure function of processed-event state: whoever steps
    a node's simulator refreshes ``recent_dlv`` and drops the telemetry
    memo (``advance_to`` does it when it pops events; the fleet clock does
    it for the nodes its interleave stepped).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol

import numpy as np

from ..core.costmodel import (build_cost_table, genai_expected_tokens,
                              genai_iso_s)
from ..core.simulator import SchedulerBase, SimResult, Simulator
from ..core.types import Accelerator, ModelGraph, Scenario, SYSTEMS


@dataclass(frozen=True)
class NodeTelemetry:
    """Router-visible snapshot of one node (all fields cheap to compute)."""

    node_id: int
    system: str
    n_accs: int
    queue_depth: int        # jobs ready or running right now
    active_streams: int     # streams currently placed here
    backlog_s: float        # summed mean to-go latency of live jobs (s)
    offered_util: float     # placed streams' offered load / accelerator count
    window_uxcost: float    # most recent UXCost window (0 before the first)
    window_dlv: float       # DLV rate over the most recent advance span
    utilization: float      # cumulative busy fraction so far
    drops: int
    draining: bool


@dataclass(frozen=True)
class StreamCost:
    """MapScore-style summary of one stream on one node's accelerator mix."""

    iso_s: float            # best-accelerator isolated latency, full pipeline
    offered_s: float        # expected busy-seconds per wall-clock second
    urgency: float          # iso latency / head period (deadline tightness)


class RoutableNode(Protocol):
    """The node surface every router policy reads. A node may also carry a
    ``system`` name: nodes of one named system share a stream's cost in
    the batched scoring path, and a node without one is costed alone."""

    node_id: int

    def telemetry(self) -> NodeTelemetry: ...


class FleetNode:
    """A member of the fleet: simulator + stream bookkeeping + telemetry."""

    def __init__(self, node_id: int, system: str | tuple[Accelerator, ...],
                 scheduler: SchedulerBase, *, duration_s: float,
                 seed: int, window_s: float = 0.5, at_t: float = 0.0,
                 genai_predictor: bool = True, engine=None, obs=None):
        self.node_id = node_id
        self.system = system if isinstance(system, str) else "custom"
        self.accs_spec = SYSTEMS[system] if isinstance(system, str) else system
        # the obs bundle is fleet-shared: every node's spans/metrics land
        # in one tracer/registry, tagged with this node's id
        self.sim = Simulator(Scenario(name=f"node{node_id}", models=()),
                             self.accs_spec, scheduler,
                             duration_s=duration_s, seed=seed,
                             window_s=window_s,
                             genai_predictor=genai_predictor,
                             engine=engine,
                             obs=obs, obs_node=node_id)
        self.sim.start(at_t=at_t)
        self.join_t = at_t
        self.draining = False
        self.alive = True
        #: placement key -> namespaced model names placed under it.  The
        #: key is opaque to the node: the fleet uses the stream id for
        #: whole-stream placements and (sid, stage) tuples in stage-split
        #: mode; keys within one run are always homogeneous
        self.placements: dict[object, list[str]] = {}
        #: sum of offered load (busy-s per s) of currently placed streams
        self.offered_s = 0.0
        #: per-model offered-load weights (cascade stages placed standalone
        #: carry their trigger probability here, since their specs no longer
        #: declare a local dependency)
        self._load_weights: dict[str, float] = {}
        self.probe_retriggers = 0
        #: SLO degradation pins: model name -> currently-active variant
        #: graph (the original graph when promoted back), so offered-load
        #: telemetry reflects what a degraded stream actually costs
        self._active_graph: dict[str, ModelGraph] = {}
        #: DLV rate over the most recent advance span (not run-cumulative,
        #: so a node is not penalized forever for early violations)
        self.recent_dlv = 0.0
        self._dlv_snapshot = (0, 0)          # (frames, violated) seen so far
        #: memoized telemetry() snapshot.  Telemetry walks every live job;
        #: the router reads it once per node per placement and once per
        #: candidate per rebalanced stream — identical values within one
        #: fleet event, since node state only changes through the
        #: invalidation points below (advance/place/evict/swap/phase)
        self._tel_cache: "Optional[NodeTelemetry]" = None
        #: fleet-installed dirty hook (node_id -> None): fires whenever the
        #: telemetry memo is invalidated, so the fleet's SoA telemetry
        #: columns refresh exactly the rows that can have changed
        self.tel_dirty_hook = None
        #: id(graph) -> (graph pin, iso_best_s) memo for _iso_best
        self._iso_cache: dict[int, tuple] = {}

    def _invalidate_telemetry(self) -> None:
        self._tel_cache = None
        if self.tel_dirty_hook is not None:
            self.tel_dirty_hook(self.node_id)

    # ------------------------------------------------------------- clock
    def advance_to(self, t: float) -> None:
        # telemetry is a pure function of processed-event state: when the
        # clock advance pops no events, every reading (backlog, util span,
        # merged DLV counters) is unchanged, so the memo stays valid
        if self.alive and self.sim.step_until(t):
            self._update_recent_dlv()
            self._invalidate_telemetry()

    def _update_recent_dlv(self) -> None:
        # O(1): the simulator keeps running totals over global_stats (the
        # same integers the old per_model walk summed at every advance)
        frames = self.sim.merged_frames
        viol = self.sim.merged_violated
        df = frames - self._dlv_snapshot[0]
        if df > 0:
            self.recent_dlv = (viol - self._dlv_snapshot[1]) / df
            self._dlv_snapshot = (frames, viol)

    def finalize(self) -> SimResult:
        return self.sim.finalize()

    # -------------------------------------------------------- placement
    def place(self, key: object, specs: list, names: list[str],
              t: float, weights: "Optional[list[float]]" = None) -> None:
        """Join a stream's pipeline — or a single stage of one — under
        ``key`` (ModelSpecs in dependency order, head first).  ``weights``
        overrides the offered-load weight per spec (the fleet passes the
        stage's trigger probability for standalone cascade stages, keeping
        load telemetry consistent across placement granularities)."""
        self._invalidate_telemetry()
        for spec in specs:
            self.sim.join_model(spec, t)
        self.placements[key] = list(names)
        for i, (g, fps, weight) in enumerate(_spec_loads(specs)):
            if weights is not None:
                weight = weights[i]
            self._load_weights[names[i]] = weight
            self.offered_s += weight * fps * self._iso_best(g)
        self.retrigger_probe()

    def evict(self, key: object, t: float) -> None:
        """Stop a placement's arrivals here (jobs in flight still
        complete, and exported completions still drain)."""
        for name in self.placements.pop(key, ()):
            self.sim.leave_model(name, t)
            # every re-placement mints a generation-fresh name, so a
            # weight kept past eviction would never be read again
            self._load_weights.pop(name, None)
            self._active_graph.pop(name, None)
        # offered load is recomputed from scratch on eviction: the spec
        # objects are gone, so track via the remaining placements instead
        self._recompute_offered()
        self.retrigger_probe()

    def release(self, key: object, t: float) -> int:
        """Departure eviction: evict the placement *and* purge its queued
        (not-yet-running) jobs — the stream left, so its backlog vanishes
        with it instead of counting as violations (migration eviction, by
        contrast, lets queued jobs finish: the stream still exists, only
        elsewhere).  Returns the number of jobs purged."""
        names = list(self.placements.get(key, ()))
        self.evict(key, t)
        return sum(self.sim.purge_model(name) for name in names)

    def swap_level(self, names: "list[str]", level: int, t: float) -> None:
        """Apply an SLO degradation-ladder level to the placed models in
        ``names``: pin each onto its ``level``-th supernet variant (0 =
        original quality; models without variants are untouched), then
        refresh offered-load telemetry and re-arm the (alpha, beta) probe —
        a quality swap is a workload change by definition."""
        for name in names:
            self._active_graph[name] = self.sim.swap_variant(name, level, t)
        self._recompute_offered()
        self.retrigger_probe()

    def _recompute_offered(self) -> None:
        self._invalidate_telemetry()
        live = {n for names in self.placements.values() for n in names}
        total = 0.0
        for i, spec in enumerate(self.sim.specs):
            if spec.model.name in live and self.sim.active[i]:
                w = self._load_weights.get(
                    spec.model.name,
                    1.0 if spec.depends_on is None else spec.trigger_prob)
                g = self._active_graph.get(spec.model.name, spec.model)
                total += w * spec.fps * self._iso_best(g)
        self.offered_s = total

    def retrigger_probe(self) -> None:
        """Membership/placement churn re-arms the node's (alpha, beta)
        probe — the simulator-level analogue of the paper's workload-change
        re-trigger, signalled explicitly by the fleet."""
        fn = getattr(self.sim.scheduler, "retrigger_probe", None)
        if fn is not None:
            fn()
            self.probe_retriggers += 1

    # -------------------------------------------------------- estimates
    def _iso_best(self, graph: ModelGraph) -> float:
        # memoized per node: candidate evaluation asks for the same few
        # graphs thousands of times; the graph is pinned in the value so
        # its id cannot be recycled while the entry lives
        hit = self._iso_cache.get(id(graph))
        if hit is not None and hit[0] is graph:
            return hit[1]
        table = build_cost_table(graph, self.accs_spec)
        if graph.genai is not None:
            # autoregressive streams are priced at the *expected* generation
            # length: the router and SLO ladder see the predictor's view,
            # not one decode pass and not the worst-case cap.  The blind
            # ablation prices every surface at the cap, so admission and
            # the degradation ladder act on phantom decode load
            n = (genai_expected_tokens(graph.genai)
                 if self.sim.genai_predictor
                 else float(graph.genai.max_new_tokens))
            iso = float(genai_iso_s(table, graph.genai, n).min())
        else:
            iso = table.iso_best_s
        if len(self._iso_cache) >= 4096:
            self._iso_cache.clear()
        self._iso_cache[id(graph)] = (graph, iso)
        return iso

    def stream_cost(self, graphs: list[tuple[ModelGraph, float, float]],
                    head_period_s: float) -> StreamCost:
        """Estimate a candidate stream on this node.  ``graphs`` is a list
        of (graph, fps, weight) with weight = cascade trigger probability
        (1.0 for heads); cost tables are memoized so this is cheap."""
        iso = 0.0
        offered = 0.0
        for g, fps, weight in graphs:
            best = self._iso_best(g)
            iso += weight * best
            offered += weight * fps * best
        urgency = iso / max(head_period_s, 1e-9)
        return StreamCost(iso_s=iso, offered_s=offered, urgency=urgency)

    # -------------------------------------------------------- telemetry
    def telemetry(self) -> NodeTelemetry:
        if self._tel_cache is not None:
            return self._tel_cache
        sim = self.sim
        if sim.soa is not None and len(sim.jobs) >= 16:
            # SoA arm: togo_mean holds exactly Job.togo() per live row in
            # jid (dict) order, and cumsum accumulates sequentially — the
            # same left-to-right float64 additions as the scalar sum()
            # below (the size gate is a pure perf crossover, not semantic)
            rows = sim.soa.live_rows()
            n_live = len(rows)
            backlog = (float(np.cumsum(sim.soa.togo_mean[rows])[-1])
                       if n_live else 0.0)
        else:
            live = [j for j in sim.jobs.values() if not j.done]
            n_live = len(live)
            backlog = sum(j.togo() for j in live)
        n_accs = len(sim.accs)
        if sim.windows:
            _, wux, _, _ = sim.windows[-1]
        else:
            wux = 0.0
        span = max(sim.t - self.join_t, 1e-9)   # busy fraction since join
        util = sum(a.busy_time for a in sim.accs) / (n_accs * span)
        self._tel_cache = tel = NodeTelemetry(
            node_id=self.node_id,
            system=self.system,
            n_accs=n_accs,
            queue_depth=n_live,
            active_streams=len(self.placements),
            backlog_s=backlog,
            offered_util=self.offered_s / n_accs,
            window_uxcost=wux,
            window_dlv=self.recent_dlv,
            utilization=min(util, 1.0),
            drops=sim.drops,
            draining=self.draining,
        )
        return tel


def _spec_loads(specs: list) -> list[tuple[ModelGraph, float, float]]:
    return [(s.model, s.fps, 1.0 if s.depends_on is None else s.trigger_prob)
            for s in specs]
