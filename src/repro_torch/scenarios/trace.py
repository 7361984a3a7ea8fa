"""Recorded traces: JSONL in, the head-of-pipeline arrivals out (the part of
``repro/scenarios/trace.py`` that the serving engine's ``TraceReplayQueue``
needs, copied: the port may not import the JAX package).

The format is the JAX package's, so a trace its simulator wrote loads here
unchanged (one JSON object per line, ``sort_keys`` so identical runs give
identical bytes):

    {"type": "meta", "version": 1, "scenario": ..., "seed": ..., ...}
    {"type": "arrival", "t": 0.0123, "model": "kws_res8"}
    {"type": "phase", "t": 2.0, "action": {"kind": "scale_fps", ...}}
    {"type": "tokens", "t": 0.0123, "model": "chat_llm", "n": 7}
    {"type": "preempt", "t": 0.5, "model": "chat_llm", "acc": 1}

Every event kind is kept in ``Trace.events``; the serving engine replays the
arrivals only (dependent streams are cascade-triggered from its own seeded
generator and need no recording).
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

    def arrivals_by_model(self) -> dict[str, list[float]]:
        out: dict[str, list[float]] = {}
        for t, m in self.arrivals:
            out.setdefault(m, []).append(t)
        return out


class TraceRecorder:
    """Collects arrival events in processing order during a live run."""

    def __init__(self, meta: dict):
        self.meta = dict(meta)
        self.meta.setdefault("version", TRACE_VERSION)
        self.events: list[dict] = []

    def arrival(self, t: float, model: str) -> None:
        self.events.append({"type": "arrival", "t": float(t), "model": model})

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
    """Parse a JSONL trace. ``event_kinds`` is the set of accepted event
    types (the default is the JAX simulator's trace)."""
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


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return loads(f.read())
