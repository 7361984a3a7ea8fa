"""Trace record/replay: seeded generation -> JSONL -> exact replay.

A trace is the complete externally-visible stochastic input of a run: the
head-of-pipeline frame arrivals (dependent models are cascade-triggered
from the engine's own seeded generator and need no recording) plus any
phase-script mutations, in the order the engine processed them.  Replaying
a trace through a simulator constructed with the same seed reproduces the
live run bit-for-bit — same jobs, same dispatches, same UXCost — because
arrival randomness lives on a dedicated generator, separate from the
path-sampling / cascade generator.

JSONL format (one JSON object per line, ``sort_keys`` so identical runs
produce identical bytes):

    {"type": "meta", "version": 1, "scenario": ..., "seed": ..., ...}
    {"type": "arrival", "t": 0.0123, "model": "kws_res8"}
    {"type": "phase", "t": 2.0, "action": {"kind": "scale_fps", ...}}
    {"type": "tokens", "t": 0.0123, "model": "chat_llm", "n": 7}
    {"type": "preempt", "t": 0.5, "model": "chat_llm", "acc": 1}

``tokens`` records an autoregressive job's sampled generation length (a
draw on the simulator's dedicated token stream); replay feeds the draws
back per-model in creation order, so the token stream — like the arrival
stream — is never consumed during replay.  ``preempt`` marks a mid-decode
job yielding its accelerator to another job at a token boundary; it is
informational (replay derives nothing from it).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

TRACE_VERSION = 1


@dataclass
class Trace:
    meta: dict
    events: list[dict] = field(default_factory=list)  # occurrence order

    @property
    def arrivals(self) -> list[tuple[float, str]]:
        return [(e["t"], e["model"]) for e in self.events
                if e["type"] == "arrival"]

    @property
    def phases(self) -> list[tuple[float, dict]]:
        return [(e["t"], e["action"]) for e in self.events
                if e["type"] == "phase"]

    def arrivals_by_model(self) -> dict[str, list[float]]:
        out: dict[str, list[float]] = {}
        for t, m in self.arrivals:
            out.setdefault(m, []).append(t)
        return out

    def tokens_by_model(self) -> dict[str, list[int]]:
        """Recorded generation lengths per model, in creation order."""
        out: dict[str, list[int]] = {}
        for e in self.events:
            if e["type"] == "tokens":
                out.setdefault(e["model"], []).append(int(e["n"]))
        return out


class TraceRecorder:
    """Collects events in engine-processing order during a live run."""

    def __init__(self, meta: dict):
        self.meta = dict(meta)
        self.meta.setdefault("version", TRACE_VERSION)
        self.events: list[dict] = []

    def arrival(self, t: float, model: str) -> None:
        self.events.append({"type": "arrival", "t": float(t), "model": model})

    def phase(self, t: float, action_cfg: dict) -> None:
        self.events.append({"type": "phase", "t": float(t),
                            "action": action_cfg})

    def tokens(self, t: float, model: str, n: int) -> None:
        self.events.append({"type": "tokens", "t": float(t),
                            "model": model, "n": int(n)})

    def preempt(self, t: float, model: str, acc: int) -> None:
        self.events.append({"type": "preempt", "t": float(t),
                            "model": model, "acc": int(acc)})

    def trace(self) -> Trace:
        return Trace(meta=dict(self.meta), events=list(self.events))


def dumps(trace: Trace) -> str:
    lines = [json.dumps({"type": "meta", **trace.meta}, sort_keys=True)]
    lines += [json.dumps(e, sort_keys=True) for e in trace.events]
    return "\n".join(lines) + "\n"


def loads(text: str, *,
          event_kinds: tuple[str, ...] = ("arrival", "phase",
                                          "tokens", "preempt"),
          version: int = TRACE_VERSION) -> Trace:
    """Parse a JSONL trace.  ``event_kinds`` is the set of accepted event
    types — the default is the simulator trace; layered formats (the fleet
    trace) pass their own kinds and version."""
    meta: dict = {}
    events: list[dict] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        kind = obj.pop("type", None)
        if kind == "meta":
            meta = obj
        elif kind in event_kinds:
            events.append({"type": kind, **obj})
        else:
            raise ValueError(f"trace line {lineno}: unknown type {kind!r}")
    if meta.get("version", version) != version:
        raise ValueError(f"unsupported trace version {meta.get('version')}")
    return Trace(meta=meta, events=events)


def save_trace(trace: Trace, path: str) -> str:
    with open(path, "w") as f:
        f.write(dumps(trace))
    return path


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return loads(f.read())
