"""Fleet trace: the fleet run's external input + routing decisions, JSONL
(copy of ``repro/cluster/trace.py``; the bytes it writes equal the
reference's, so a trace recorded by either package replays in the other).

This module owns the on-disk contract of a fleet run.  It layers on
:mod:`repro_torch.scenarios.trace` (same container, same JSONL conventions,
``sort_keys`` bytes-stable lines) with fleet-level event kinds.  A fleet
trace records, in processing order:

    {"type": "meta", "kind": "fleet", "version": 1, "seed": ..., ...}
    {"type": "node_join",  "t": 0.0, "node": 0, "system": "4K_2WS"}
    {"type": "stream",     "t": 0.3, "sid": 4, "entries": [...]}
    {"type": "place",      "t": 0.3, "sid": 4, "node": 2, "gen": 0}
    {"type": "node_drain", "t": 1.0, "node": 1}
    {"type": "migrate",    "t": 1.0, "sid": 3, "from": 1, "to": 0, "gen": 1}
    {"type": "depart",     "t": 1.2, "sid": 4, "purged": 3}
    {"type": "rejoin",     "t": 1.4, "sid": 4}
    {"type": "place",      "t": 1.4, "sid": 4, "node": 0, "gen": 1}
    {"type": "node_leave", "t": 1.5, "node": 3}

Stream lifecycle records: ``depart`` is an *input* (re-applied on replay
— the eviction and backlog purge re-derive identically; the recorded
``purged`` count only documents what the live run discarded), and
``rejoin`` is an input whose re-placement *decisions* follow as ordinary
generation-bumped ``place`` records, so replay bypasses the router for
rejoins exactly as it does for arrivals.

Stage-split runs (``FleetSimulator(split_stages=True)``) additionally carry
a ``"stage"`` index on ``place``/``migrate`` events, and migrations under a
transfer model carry the exact charge the live run paid:

    {"type": "place",   "t": 0.3, "sid": 4, "stage": 1, "node": 5, "gen": 0}
    {"type": "migrate", "t": 1.0, "sid": 3, "stage": 0, "from": 1, "to": 0,
     "gen": 1, "xfer_s": 0.0082, "xfer_j": 3.1e-4}

Fleet phase events (workload mutations, e.g. diurnal load shifts) and
online-tuner decisions are first-class records too:

    {"type": "phase", "t": 1.2, "action": {"kind": "scale_fps",
     "factor": 2.5, "models": null}, "sids": [0, 1, 2]}
    {"type": "tune",  "t": 1.5, "weights": [1.0, 0.62, 0.2, 0.15, 8.0],
     "window_uxcost": 41.2, "probing": true}

Phase events are *inputs* — replay re-applies them to the hosting nodes.
Tune events are recorded *decisions*: replay installs the recorded weight
vector directly and never constructs telemetry or steps the probe, so a
tuned run replays bit-exactly even though the tuner consumed an RNG
stream live (see ``docs/traces.md``).

SLO-subsystem records: tiered streams carry their class on the arrival
record (``"slo"``, omitted for tierless streams — legacy traces stay
byte-stable), and the admission controller's decisions are recorded as
``swap`` (degradation-ladder variant moves) and ``reject`` (refused
placements) so replay bypasses the controller entirely:

    {"type": "stream", "t": 0.3, "sid": 4, "entries": [...],
     "slo": {"tier": 2}}
    {"type": "swap",   "t": 0.9, "sid": 4, "level": 2, "pressure": 0.97}
    {"type": "reject", "t": 1.1, "sid": 7, "tier": 2, "pressure": 1.12}

The meta line carries ``"transfer"`` (the exact TransferModel parameters)
and ``"split"`` when stage splitting was live; replay reconstructs the
model from meta and re-derives every charge through the same code path,
so a trace stays exact even if the *default* transfer constants change
later.  The per-migration ``xfer_s``/``xfer_j`` fields document what the
live run paid (and are asserted in tests); legacy whole-stream traces are
byte-identical to the original
whole-stream format.

Invariant: because placements *and* migrations are recorded (not just the
inputs), replay bypasses the router entirely — a 16-node/1000-stream run
reproduces bit-exactly (same per-node simulators, same jobs, same fleet
UXCost) regardless of later routing-policy changes.  Cross-node cascade
triggers are deliberately NOT recorded: they are deterministic internal
dynamics (a dedicated fleet trigger RNG + the deterministic interleaved
clock), fully determined by the recorded placements.
"""
from __future__ import annotations

from typing import Optional

from ..scenarios import trace as base

FLEET_TRACE_VERSION = 1
FLEET_EVENT_KINDS = ("node_join", "node_leave", "node_drain",
                     "stream", "depart", "rejoin",
                     "place", "migrate", "phase", "tune",
                     "swap", "reject")


class FleetTrace(base.Trace):
    """A recorded fleet run (meta + ordered fleet events)."""

    def events_of(self, kind: str) -> list[dict]:
        return [e for e in self.events if e["type"] == kind]

    @property
    def placements(self) -> list[dict]:
        return self.events_of("place")

    @property
    def migrations(self) -> list[dict]:
        return self.events_of("migrate")


class FleetTraceRecorder:
    """Collects fleet events in processing order during a live run."""

    def __init__(self, meta: dict):
        self.meta = dict(meta)
        self.meta.setdefault("version", FLEET_TRACE_VERSION)
        self.meta.setdefault("kind", "fleet")
        self.events: list[dict] = []

    def node_join(self, t: float, node: int, system: str) -> None:
        self.events.append({"type": "node_join", "t": float(t),
                            "node": node, "system": system})

    def node_leave(self, t: float, node: int) -> None:
        self.events.append({"type": "node_leave", "t": float(t),
                            "node": node})

    def node_drain(self, t: float, node: int) -> None:
        self.events.append({"type": "node_drain", "t": float(t),
                            "node": node})

    def stream(self, t: float, sid: int, entries: list[dict],
               slo: Optional[dict] = None) -> None:
        """A stream arrival.  ``slo`` carries the declared SLO class config
        when the stream is tiered; omitted entirely for tierless streams,
        which keeps legacy (pre-SLO) traces byte-stable."""
        ev: dict = {"type": "stream", "t": float(t), "sid": sid,
                    "entries": entries}
        if slo is not None:
            ev["slo"] = dict(slo)
        self.events.append(ev)

    def depart(self, t: float, sid: int, purged: int) -> None:
        """A stream departing (load release).  ``purged`` documents how
        many queued jobs the departure discarded; replay re-derives the
        purge through the same eviction path and ignores the field."""
        self.events.append({"type": "depart", "t": float(t), "sid": sid,
                            "purged": int(purged)})

    def rejoin(self, t: float, sid: int) -> None:
        """A departed stream returning; the re-placement decisions follow
        as ordinary ``place`` records (generation-bumped)."""
        self.events.append({"type": "rejoin", "t": float(t), "sid": sid})

    def place(self, t: float, sid: int, node: int, gen: int,
              stage: Optional[int] = None) -> None:
        ev = {"type": "place", "t": float(t), "sid": sid,
              "node": node, "gen": gen}
        if stage is not None:
            ev["stage"] = stage
        self.events.append(ev)

    def migrate(self, t: float, sid: int, src: int, dst: int, gen: int,
                stage: Optional[int] = None,
                xfer_s: Optional[float] = None,
                xfer_j: Optional[float] = None) -> None:
        ev = {"type": "migrate", "t": float(t), "sid": sid,
              "from": src, "to": dst, "gen": gen}
        if stage is not None:
            ev["stage"] = stage
        if xfer_s is not None:
            ev["xfer_s"] = float(xfer_s)
        if xfer_j is not None:
            ev["xfer_j"] = float(xfer_j)
        self.events.append(ev)

    def phase(self, t: float, action: dict,
              sids: "Optional[list[int]]" = None) -> None:
        """A fleet-level phase event (workload mutation): the serialized
        PhaseAction config plus the targeted stream ids (None = all)."""
        ev: dict = {"type": "phase", "t": float(t), "action": dict(action)}
        if sids is not None:
            ev["sids"] = list(sids)
        self.events.append(ev)

    def tune(self, t: float, weights: "list[float]",
             window_uxcost: float, probing: bool) -> None:
        """A tuner decision: the full weight vector committed for the next
        telemetry window (``repro_torch.cluster.router.WEIGHT_NAMES`` order).
        Replay installs these weights directly, bypassing telemetry and
        probe entirely; ``window_uxcost`` (the measurement that produced
        the decision) and ``probing`` document the tuner state."""
        self.events.append({
            "type": "tune", "t": float(t),
            "weights": [float(w) for w in weights],
            "window_uxcost": float(window_uxcost),
            "probing": bool(probing),
        })

    def swap(self, t: float, sid: int, level: int,
             pressure: Optional[float] = None) -> None:
        """An SLO degradation-ladder decision: stream ``sid`` moves to
        supernet-variant ``level`` (0 = full quality; k = k-th variant,
        heavier->lighter).  Replay applies the recorded level directly and
        never runs the admission controller; ``pressure`` documents the
        admission-law scalar that drove the move."""
        ev: dict = {"type": "swap", "t": float(t), "sid": sid,
                    "level": int(level)}
        if pressure is not None:
            ev["pressure"] = float(pressure)
        self.events.append(ev)

    def reject(self, t: float, sid: int, tier: int,
               pressure: Optional[float] = None) -> None:
        """An admission rejection: stream ``sid`` (service tier ``tier``)
        was refused placement — a first-class outcome that charges the
        stream's expected frames as deadline violations into the fleet
        UXCost.  Replay applies the rejection directly."""
        ev: dict = {"type": "reject", "t": float(t), "sid": sid,
                    "tier": int(tier)}
        if pressure is not None:
            ev["pressure"] = float(pressure)
        self.events.append(ev)

    def trace(self) -> FleetTrace:
        return FleetTrace(meta=dict(self.meta), events=list(self.events))


def dumps(trace: FleetTrace) -> str:
    return base.dumps(trace)


def loads(text: str) -> FleetTrace:
    t = base.loads(text, event_kinds=FLEET_EVENT_KINDS,
                   version=FLEET_TRACE_VERSION)
    if t.meta.get("kind") != "fleet":
        raise ValueError("not a fleet trace (meta.kind != 'fleet')")
    return FleetTrace(meta=t.meta, events=t.events)


def save_trace(trace: FleetTrace, path: str) -> str:
    with open(path, "w") as f:
        f.write(dumps(trace))
    return path


def load_trace(path: str) -> FleetTrace:
    with open(path) as f:
        return loads(f.read())
