"""Fleet scenarios: node membership + stream arrivals as declarative data
(copy of ``repro/cluster/builder.py``, over the port's
``scenarios.builder`` and ``scenarios.fuzzer``).

A :class:`FleetScenario` is an ordered list of timed fleet events — nodes
joining/leaving/draining, streams arriving, *departing and rejoining*
(the full task lifecycle: RTMM tasks stop when the user's context
changes, not only start), fleet-level phase events (stream-addressed
workload mutations such as diurnal load shifts) —
exactly the external input a multi-node deployment sees.  The builder shards existing single-node
workload definitions across the fleet: a registry scenario or a fuzzer
sample splits into its independent pipelines (a head model plus its
cascade children), each becoming one routable stream whose stages the
stage-split router may later place on different nodes.

Invariants:

  * everything is plain data (``to_config``/``from_config``): fleet
    scenarios serialize, and fleet traces can embed the streams they
    placed;
  * every stream starts with a head entry and names its models explicitly
    (serializable ModelRefs) — the fleet's placement-generation
    namespacing needs stable base names;
  * ``build()`` enforces temporal consistency (no drain/leave before the
    node's join) and sorts events by (time, declaration order);
  * fuzzed populations are deterministic at build time — the resulting
    FleetScenario needs no runtime randomness.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from ..scenarios.builder import ModelEntry, ScenarioBuilder, ScenarioError
from ..scenarios.fuzzer import fuzz_scenario

from .slo import slo_from_config


# ---------------------------------------------------------------------------
# Fuzzed-population specification
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CascadeFuzz:
    """Cascade shape of a fuzzed population."""

    prob: float = 0.5           # per-child trigger probability
    max_depth: int = 2          # max cascade chain length
    only: bool = False          # drop single-stage pipelines entirely
    max_pipelines: int = 1      # pipelines per fuzzer sample


@dataclass(frozen=True)
class LifecycleFuzz:
    """Stream departure/rejoin churn of a fuzzed population."""

    depart_frac: float = 0.0    # fraction of streams departing mid-run
    rejoin_frac: float = 0.0    # fraction of departures that rejoin
    t0: "float | None" = None   # depart window start (default: arrival t1)
    t1: "float | None" = None   # depart window end (default: 2 * arrival t1)


@dataclass(frozen=True)
class SLOFuzz:
    """Service-tier structure of a fuzzed population."""

    #: (tier-0, tier-1, best-effort) draw weights; None = tierless
    tier_mix: "tuple[float, float, float] | None" = None
    #: fraction of stream heads re-headed onto the OFA supernet
    #: (index-strided, no RNG) so the degradation ladder has rungs
    supernet_frac: float = 0.0


@dataclass(frozen=True)
class GenAIFuzz:
    """Autoregressive share of a fuzzed population."""

    #: fraction of stream heads re-headed onto the chat_llm generative
    #: family (index-strided, no RNG; wins over the supernet stride on
    #: collisions) — token-level preemption and the length predictor then
    #: have traffic to act on
    frac: float = 0.0


#: generation-length profiles cycled (deterministically, by genai-stream
#: index) across fuzzed chat heads: short replies, medium chat turns, long
#: form.  Heterogeneous caps are what separate a blind scheduler (prices
#: every generation at max_new_tokens) from the EWMA length predictor
GENAI_PROFILES: "tuple[dict, ...]" = (
    {"max_new_tokens": 16, "token_mean": 6.0},
    {"max_new_tokens": 24, "token_mean": 10.0},
    {"max_new_tokens": 48, "token_mean": 18.0},
)


@dataclass(frozen=True)
class FuzzSpec:
    """Full specification of one seeded fuzz_streams population.

    Replaces the historical 16-kwarg call form; sub-specs group the knobs
    by subsystem.  For a fixed (seed, knobs) combination the population is
    byte-stable against the legacy form (the reference's
    tests/test_fuzz_spec.py pins the recorded fingerprints)."""

    n_streams: int
    seed: int
    t0: float = 0.0             # arrival window start
    t1: float = 1.0             # arrival window end
    fps_scale: float = 1.0
    deterministic_arrivals: bool = False
    cascade: CascadeFuzz = field(default_factory=CascadeFuzz)
    lifecycle: LifecycleFuzz = field(default_factory=LifecycleFuzz)
    slo: SLOFuzz = field(default_factory=SLOFuzz)
    genai: GenAIFuzz = field(default_factory=GenAIFuzz)


def _legacy_fuzz_spec(n_streams: int, seed: int, t0: float = 0.0,
                      t1: float = 1.0, max_pipelines: int = 1,
                      fps_scale: float = 1.0, cascade_prob: float = 0.5,
                      max_depth: int = 2, cascades_only: bool = False,
                      deterministic_arrivals: bool = False,
                      depart_frac: float = 0.0, rejoin_frac: float = 0.0,
                      t_depart0: "float | None" = None,
                      t_depart1: "float | None" = None,
                      tier_mix: "tuple[float, float, float] | None" = None,
                      supernet_frac: float = 0.0,
                      genai_frac: float = 0.0) -> FuzzSpec:
    """Map the historical flat kwargs onto a :class:`FuzzSpec`."""
    return FuzzSpec(
        n_streams=int(n_streams), seed=int(seed), t0=t0, t1=t1,
        fps_scale=fps_scale, deterministic_arrivals=deterministic_arrivals,
        cascade=CascadeFuzz(prob=cascade_prob, max_depth=max_depth,
                            only=cascades_only, max_pipelines=max_pipelines),
        lifecycle=LifecycleFuzz(depart_frac=depart_frac,
                                rejoin_frac=rejoin_frac,
                                t0=t_depart0, t1=t_depart1),
        slo=SLOFuzz(tier_mix=None if tier_mix is None else tuple(tier_mix),
                    supernet_frac=supernet_frac),
        genai=GenAIFuzz(frac=genai_frac),
    )


@dataclass(frozen=True)
class FleetEvent:
    """One timed fleet-level event (serializable kind + payload)."""

    t: float
    #: node_join | node_leave | node_drain | stream | depart | rejoin | phase
    kind: str
    payload: dict

    def to_config(self) -> dict:
        return {"t": self.t, "kind": self.kind, **self.payload}

    @classmethod
    def from_config(cls, cfg: dict) -> "FleetEvent":
        d = dict(cfg)
        return cls(t=float(d.pop("t")), kind=d.pop("kind"), payload=d)


@dataclass(frozen=True)
class FleetScenario:
    """A full fleet workload: membership churn + stream arrivals."""

    name: str
    events: tuple[FleetEvent, ...]      # sorted by (t, declaration order)

    def to_config(self) -> dict:
        return {"name": self.name,
                "events": [e.to_config() for e in self.events]}

    @classmethod
    def from_config(cls, cfg: dict) -> "FleetScenario":
        return cls(name=cfg["name"],
                   events=tuple(FleetEvent.from_config(e)
                                for e in cfg["events"]))

    @property
    def n_nodes(self) -> int:
        return sum(1 for e in self.events if e.kind == "node_join")

    @property
    def n_streams(self) -> int:
        return sum(1 for e in self.events if e.kind == "stream")


def split_pipelines(builder: ScenarioBuilder) -> list[list[dict]]:
    """Shard a scenario into its independent pipelines (head + cascade
    children), as lists of serialized ModelEntry configs, head first.
    Cross-pipeline dependencies cannot exist (the scenario builder only
    allows forward references), so pipelines route independently."""
    builder.validate()
    pipelines: list[list[dict]] = []
    owner: dict[str, int] = {}      # model name -> pipeline index
    for entry in builder.entries:
        cfg = entry.to_config()
        # pin the effective instance name so fleet namespacing is stable
        cfg["model"]["name"] = entry.model_name
        if entry.depends_on is None:
            owner[entry.model_name] = len(pipelines)
            pipelines.append([cfg])
        else:
            pidx = owner[entry.depends_on]
            owner[entry.model_name] = pidx
            pipelines[pidx].append(cfg)
    return pipelines


class FleetScenarioBuilder:
    """Fluent builder for fleet scenarios."""

    def __init__(self, name: str):
        self.name = name
        self._events: list[FleetEvent] = []
        self._next_node = 0
        self._next_sid = 0
        self._node_ids: set[int] = set()

    # -------------------------------------------------------- membership
    def node(self, system: str = "4K_1WS2OS", at: float = 0.0) -> int:
        """Declare a node joining the fleet at time ``at`` (a Table-2
        system name). Returns its node id."""
        nid = self._next_node
        self._next_node += 1
        self._node_ids.add(nid)
        self._events.append(FleetEvent(float(at), "node_join",
                                       {"node": nid, "system": system}))
        return nid

    def node_leave(self, node_id: int, at: float) -> "FleetScenarioBuilder":
        """Abrupt departure: the node stops at ``at``; its streams migrate,
        jobs in flight there are lost."""
        self._check_node(node_id)
        self._events.append(FleetEvent(float(at), "node_leave",
                                       {"node": node_id}))
        return self

    def node_drain(self, node_id: int, at: float) -> "FleetScenarioBuilder":
        """Graceful departure: streams migrate away at ``at`` and the node
        stops accepting placements, but keeps executing its queue."""
        self._check_node(node_id)
        self._events.append(FleetEvent(float(at), "node_drain",
                                       {"node": node_id}))
        return self

    def _check_node(self, node_id: int) -> None:
        if node_id not in self._node_ids:
            raise ScenarioError(f"unknown fleet node id {node_id}")

    # ------------------------------------------------------------- phases
    #: fleet-level phase-action kinds: mutations that apply uniformly to a
    #: *stream* (every stage of it, wherever placed).  Model-addressed
    #: actions (set_fps, set_trigger_prob, join, leave) stay node-local —
    #: their model names are namespaced per placement, which a scenario
    #: cannot know ahead of routing.
    FLEET_PHASE_KINDS = ("scale_fps",)

    def phase(self, action, at: float,
              sids: "list[int] | None" = None) -> "FleetScenarioBuilder":
        """A timed fleet-level workload mutation: apply ``action`` (a
        ``repro_torch.scenarios.phases.PhaseAction`` or its config dict) to the
        streams in ``sids`` (None = every stream declared so far) at time
        ``at``.  The fleet forwards the action to each targeted stream's
        hosting node(s), re-arms the touched nodes' (alpha, beta) probes,
        and — under a tuned router — re-arms the fleet weight tuner: a
        phase event is a workload change by definition."""
        cfg = action if isinstance(action, dict) else action.to_config()
        if cfg.get("kind") not in self.FLEET_PHASE_KINDS:
            raise ScenarioError(
                f"fleet phase supports kinds {self.FLEET_PHASE_KINDS}, "
                f"got {cfg.get('kind')!r}")
        if cfg.get("models") is not None:
            raise ScenarioError("fleet phase actions target streams via "
                                "`sids`, not model names (placement "
                                "namespacing owns the names)")
        if sids is not None:
            unknown = [s for s in sids if not 0 <= s < self._next_sid]
            if unknown:
                raise ScenarioError(f"phase targets unknown stream ids "
                                    f"{unknown}")
            sids = [int(s) for s in sids]
        payload: dict = {"action": dict(cfg)}
        if sids is not None:
            payload["sids"] = sids
        self._events.append(FleetEvent(float(at), "phase", payload))
        return self

    # --------------------------------------------------- stream lifecycle
    def depart(self, sid: int, at: float) -> "FleetScenarioBuilder":
        """Stream ``sid`` departs at ``at`` — the load-release half of
        task-level dynamicity: the user's context changed and the task
        stopped.  The fleet evicts the stream from its hosting node(s),
        purges its queued (not-yet-running) frames from the backlog
        without counting them against UXCost, and re-arms the touched
        nodes' probes and the fleet weight tuner.  ``build()`` validates
        ordering: a depart must follow the stream's arrival (and any
        earlier depart must have been rejoined)."""
        self._check_sid(sid)
        self._events.append(FleetEvent(float(at), "depart", {"sid": sid}))
        return self

    def rejoin(self, sid: int, at: float) -> "FleetScenarioBuilder":
        """A departed stream returns at ``at`` with its recorded pipeline
        definition: the router re-places it (fresh placement generation)
        exactly like a new arrival.  Must follow a ``depart`` of the same
        stream (validated by ``build()``)."""
        self._check_sid(sid)
        self._events.append(FleetEvent(float(at), "rejoin", {"sid": sid}))
        return self

    def _check_sid(self, sid: int) -> None:
        if not 0 <= sid < self._next_sid:
            raise ScenarioError(f"unknown stream id {sid}")

    # ----------------------------------------------------------- streams
    def add_stream(self, entries: "list[dict] | list[ModelEntry]",
                   at: float = 0.0, slo: "int | dict | None" = None) -> int:
        """One routable stream: a pipeline of ModelEntry configs (head
        first).  ``slo`` optionally declares the stream's service tier (a
        bare tier number or an SLO config dict — see
        :mod:`repro_torch.cluster.slo`); validated here, carried in the event
        payload, and omitted entirely for tierless streams so legacy
        scenarios and traces stay byte-stable.  Returns the stream id."""
        cfgs = []
        for e in entries:
            cfg = e.to_config() if isinstance(e, ModelEntry) else dict(e)
            if cfg.get("model", {}).get("name") is None:
                raise ScenarioError("fleet stream entries need explicit "
                                    "model names (serializable ModelRefs)")
            cfgs.append(cfg)
        if not cfgs:
            raise ScenarioError("fleet stream has no entries")
        if cfgs[0].get("depends_on") is not None:
            raise ScenarioError("fleet stream must start with a head entry")
        sid = self._next_sid
        self._next_sid += 1
        payload: dict = {"sid": sid, "entries": cfgs}
        if slo is not None:
            payload["slo"] = slo_from_config(slo).to_config()
        self._events.append(FleetEvent(float(at), "stream", payload))
        return sid

    def add_scenario(self, builder: ScenarioBuilder,
                     at: float = 0.0) -> list[int]:
        """Shard a whole single-node scenario into per-pipeline streams."""
        return [self.add_stream(p, at=at) for p in split_pipelines(builder)]

    def fuzz_streams(self, spec: "FuzzSpec | int",
                     seed: "int | None" = None, **kw) -> list[int]:
        """Seeded stream population: fuzzer-sampled pipelines with arrival
        times uniform over [spec.t0, spec.t1).  Deterministic at build
        time, so the resulting FleetScenario needs no runtime randomness.

        Pass a :class:`FuzzSpec`.  The historical flat call form —
        ``fuzz_streams(n_streams, seed, cascade_prob=..., tier_mix=...,
        ...)`` — still works, maps byte-stably onto the same populations,
        and emits a :class:`DeprecationWarning`.

        ``fps_scale`` rescales every stream's FPS targets: the fuzzer pools
        are sized for one pipeline per multi-accelerator node, while a fleet
        serves *many* light streams per node — ~0.25 puts a 12-streams-per-
        node fleet near 50% offered utilization.

        ``spec.cascade`` shapes the pipelines (``prob``/``max_depth``
        thread to the fuzzer; ``only`` drops single-stage pipelines, so
        every admitted stream has at least one cross-placeable edge).

        ``deterministic_arrivals`` replaces every sampled arrival process
        with an explicitly-phased periodic one (phase hashed from the
        stream id).  Stochastic arrival processes draw from a *per-node*
        RNG in event order, so their realizations depend on which streams
        share a node — pinning them makes the offered workload identical
        across placement policies, which is what a fair routing comparison
        (e.g. whole-pipeline vs stage-split) needs.

        ``spec.lifecycle`` makes the population churned: ``depart_frac``
        of the streams departs mid-run, each at a time uniform over
        [``t0``, ``t1``) of the lifecycle window (defaulting to
        [t1, 2*t1) of the arrival window), and ``rejoin_frac`` of the
        departed streams rejoins later.  Lifecycle draws come from a
        dedicated RNG stream, so populations with ``depart_frac=0``
        reproduce their historical arrivals bit-for-bit.

        ``spec.slo.tier_mix`` declares an SLO-tiered population: per-stream
        tiers (guaranteed / standard / best-effort) drawn with the given
        weights from a dedicated RNG stream, so tierless populations
        reproduce their historical draws bit-for-bit.  ``supernet_frac``
        swaps that fraction of stream heads (index-strided, no RNG) onto
        the OFA supernet so the SLO degradation ladder has variant rungs
        to act on; ``spec.genai.frac`` does the same onto the chat_llm
        autoregressive family (and wins on stride collisions)."""
        if isinstance(spec, FuzzSpec):
            if seed is not None or kw:
                raise ScenarioError(
                    "fuzz_streams(FuzzSpec) takes no further arguments")
            return self._fuzz_streams_impl(spec)
        warnings.warn(
            "FleetScenarioBuilder.fuzz_streams(n_streams, seed, **kwargs) "
            "is deprecated; pass a repro_torch.cluster.FuzzSpec instead",
            DeprecationWarning, stacklevel=2)
        if seed is None:
            raise ScenarioError("legacy fuzz_streams needs (n_streams, seed)")
        return self._fuzz_streams_impl(_legacy_fuzz_spec(spec, seed, **kw))

    def _fuzz_streams_impl(self, spec: "FuzzSpec") -> list[int]:
        cas, life, slo, genai = (spec.cascade, spec.lifecycle, spec.slo,
                                 spec.genai)
        n_streams, seed, t0, t1 = spec.n_streams, spec.seed, spec.t0, spec.t1
        if cas.only and not cas.prob > 0.0:
            raise ScenarioError("cascade.only with cascade.prob=0 can "
                                "never admit a stream")
        if not 0.0 <= life.depart_frac <= 1.0 \
                or not 0.0 <= life.rejoin_frac <= 1.0:
            raise ScenarioError(
                "depart_frac / rejoin_frac must be in [0, 1], got "
                f"{life.depart_frac}/{life.rejoin_frac}")
        if not 0.0 <= slo.supernet_frac <= 1.0:
            raise ScenarioError(
                f"supernet_frac must be in [0, 1], got {slo.supernet_frac}")
        if not 0.0 <= genai.frac <= 1.0:
            raise ScenarioError(
                f"genai.frac must be in [0, 1], got {genai.frac}")
        if slo.tier_mix is not None:
            if len(slo.tier_mix) != 3 or any(w < 0 for w in slo.tier_mix) \
                    or not sum(slo.tier_mix) > 0:
                raise ScenarioError(
                    "tier_mix must be three non-negative weights "
                    f"(tier-0, tier-1, best-effort), got {slo.tier_mix!r}")
        stride = (int(round(1.0 / slo.supernet_frac))
                  if slo.supernet_frac > 0 else 0)
        gstride = int(round(1.0 / genai.frac)) if genai.frac > 0 else 0
        rng = np.random.default_rng([seed, 0xF1EE7])
        sids: list[int] = []
        arrivals: list[float] = []
        k = 0
        while len(sids) < n_streams:
            b = fuzz_scenario(seed * 100_003 + k,
                              max_pipelines=cas.max_pipelines,
                              cascade_prob=cas.prob, max_depth=cas.max_depth)
            k += 1
            for pipe in split_pipelines(b):
                if len(sids) >= n_streams:
                    break
                if cas.only and len(pipe) < 2:
                    continue
                for cfg in pipe:
                    if spec.fps_scale != 1.0:
                        cfg["fps"] = float(cfg["fps"]) * spec.fps_scale
                    if spec.deterministic_arrivals:
                        phase = ((len(sids) * 7919) % 97) / 97.0
                        cfg["arrival"] = {"kind": "periodic",
                                          "phase_frac": round(phase, 6)}
                if gstride and len(sids) % gstride == 0:
                    # re-head this stream onto the chat_llm autoregressive
                    # family (keeping the sampled instance name and FPS) —
                    # no RNG, so genai-free populations are byte-identical;
                    # wins over the supernet stride on collisions (chat_llm
                    # carries its own degradation-ladder variants).  Profiles
                    # cycle deterministically so the population mixes short/
                    # medium/long generations: a blind scheduler prices every
                    # one at its cap, a length predictor tells them apart
                    prof = GENAI_PROFILES[(len(sids) // gstride)
                                          % len(GENAI_PROFILES)]
                    pipe[0]["model"] = {"builder": "chat_llm",
                                        "name": pipe[0]["model"]["name"],
                                        "kwargs": dict(prof)}
                elif stride and len(sids) % stride == 0:
                    # re-head this stream onto the OFA supernet (keeping the
                    # sampled instance name and FPS) so the degradation
                    # ladder has variant rungs in the population
                    pipe[0]["model"] = {"builder": "ofa",
                                        "name": pipe[0]["model"]["name"],
                                        "kwargs": {}}
                t = round(float(rng.uniform(t0, t1)), 6)
                sids.append(self.add_stream(pipe, at=t))
                arrivals.append(t)
        if slo.tier_mix is not None:
            # dedicated stream: tier draws must not perturb the arrival/
            # pipeline draws above for tierless populations
            trng = np.random.default_rng([seed, 0x510C1A55])
            total = float(sum(slo.tier_mix))
            c0 = slo.tier_mix[0] / total
            c1 = c0 + slo.tier_mix[1] / total
            payloads = {e.payload["sid"]: e.payload for e in self._events
                        if e.kind == "stream" and e.payload["sid"] in sids}
            for sid in sids:
                u = float(trng.random())
                tier = 0 if u < c0 else (1 if u < c1 else 2)
                payloads[sid]["slo"] = slo_from_config(tier).to_config()
        if life.depart_frac > 0.0:
            # dedicated stream: lifecycle draws must not perturb the
            # arrival/pipeline draws above for depart_frac=0 populations
            lrng = np.random.default_rng([seed, 0xDE9A27])
            d0 = t1 if life.t0 is None else float(life.t0)
            d1 = 2.0 * t1 if life.t1 is None else float(life.t1)
            n_depart = int(round(life.depart_frac * len(sids)))
            leavers = sorted(lrng.choice(len(sids), size=n_depart,
                                         replace=False).tolist())
            for i in leavers:
                # clamp to the arrival: 6-decimal rounding of a draw near
                # the window edge must not put a depart before its stream
                td = max(round(float(lrng.uniform(d0, d1)), 6), arrivals[i])
                self.depart(sids[i], at=td)
                if lrng.random() < life.rejoin_frac and td < d1:
                    self.rejoin(sids[i],
                                at=round(float(lrng.uniform(td, d1)), 6))
        return sids

    # ------------------------------------------------------------- build
    def build(self) -> FleetScenario:
        if not self._node_ids:
            raise ScenarioError(f"fleet scenario {self.name!r} has no nodes")
        if not any(e.kind == "stream" for e in self._events):
            raise ScenarioError(f"fleet scenario {self.name!r} has no streams")
        indexed = sorted(enumerate(self._events),
                         key=lambda p: (p[1].t, p[0]))
        events = tuple(e for _, e in indexed)
        joined: set[int] = set()            # temporal consistency check
        #: per-stream lifecycle state: absent -> present -> departed -> ...
        present: set[int] = set()
        departed: set[int] = set()
        for e in events:
            if e.kind == "node_join":
                joined.add(e.payload["node"])
            elif e.kind in ("node_leave", "node_drain"):
                if e.payload["node"] not in joined:
                    raise ScenarioError(
                        f"{e.kind} of node {e.payload['node']} at t={e.t} "
                        "precedes its join")
            elif e.kind == "stream":
                present.add(e.payload["sid"])
            elif e.kind == "depart":
                sid = e.payload["sid"]
                if sid not in present:
                    raise ScenarioError(
                        f"depart of stream {sid} at t={e.t} precedes its "
                        "arrival" if sid not in departed else
                        f"stream {sid} departs twice without a rejoin "
                        f"(second depart at t={e.t})")
                present.discard(sid)
                departed.add(sid)
            elif e.kind == "rejoin":
                sid = e.payload["sid"]
                if sid not in departed:
                    raise ScenarioError(
                        f"rejoin of stream {sid} at t={e.t} has no "
                        "preceding depart")
                departed.discard(sid)
                present.add(sid)
        return FleetScenario(name=self.name, events=events)
