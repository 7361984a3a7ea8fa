"""Phase scripts: timed mutations of a *running* scenario.

DREAM's adaptivity engine exists to survive workload shifts — models
joining and leaving, FPS retargeting, cascade probability swings — but a
static scenario never exercises it.  A :class:`PhaseScript` is an ordered
list of ``(time, PhaseAction)`` pairs the simulator applies as first-class
events, so a single run can sweep through several workload regimes.

Actions are plain data (kind + payload) so scripts serialize into traces
and replay exactly; the simulator re-validates every payload on apply
(traces are hand-editable) and records applied actions in processing
order.  Supported kinds:

    set_fps(model, fps)          retarget one model's FPS (period + deadline)
    scale_fps(factor[, models])  multiply FPS of all (or listed) models
    set_trigger_prob(model, p)   change a cascade's trigger probability
    leave(model)                 stop a model's arrivals / cascade triggers
    join(entry)                  add a new pipeline stage mid-run (a
                                 serializable ModelEntry — zoo ref based)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Union

from .builder import ModelEntry


@dataclass(frozen=True)
class PhaseAction:
    kind: str
    payload: dict

    def to_config(self) -> dict:
        return {"kind": self.kind, **self.payload}

    @classmethod
    def from_config(cls, cfg: dict) -> "PhaseAction":
        d = dict(cfg)
        return cls(kind=d.pop("kind"), payload=d)


def set_fps(model: str, fps: float) -> PhaseAction:
    if not fps > 0:
        raise ValueError(f"set_fps: fps must be positive, got {fps}")
    return PhaseAction("set_fps", {"model": model, "fps": float(fps)})


def scale_fps(factor: float,
              models: Optional[Sequence[str]] = None) -> PhaseAction:
    if not factor > 0:
        raise ValueError(f"scale_fps: factor must be positive, got {factor}")
    return PhaseAction("scale_fps", {
        "factor": float(factor),
        "models": None if models is None else list(models)})


def set_trigger_prob(model: str, prob: float) -> PhaseAction:
    if not 0.0 <= prob <= 1.0:
        raise ValueError(f"set_trigger_prob: {prob} outside [0, 1]")
    return PhaseAction("set_trigger_prob",
                       {"model": model, "prob": float(prob)})


def leave(model: str) -> PhaseAction:
    return PhaseAction("leave", {"model": model})


def join(entry: ModelEntry) -> PhaseAction:
    """Add a pipeline stage mid-run.  The entry must be ModelRef-based so
    the action (and any trace containing it) stays serializable."""
    return PhaseAction("join", {"entry": entry.to_config()})


def join_entry(action: PhaseAction) -> ModelEntry:
    """Materialize the ModelEntry carried by a ``join`` action."""
    assert action.kind == "join"
    return ModelEntry.from_config(action.payload["entry"])


class PhaseScript:
    """An ordered schedule of scenario mutations."""

    def __init__(self,
                 events: Iterable[tuple[float, PhaseAction]] = ()):
        self.events: list[tuple[float, PhaseAction]] = sorted(
            ((float(t), a) for t, a in events), key=lambda e: e[0])

    def at(self, t: float, action: PhaseAction) -> "PhaseScript":
        self.events.append((float(t), action))
        self.events.sort(key=lambda e: e[0])
        return self

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def to_config(self) -> list[dict]:
        return [{"t": t, "action": a.to_config()} for t, a in self.events]

    @classmethod
    def from_config(cls, cfg: Union[list, dict]) -> "PhaseScript":
        events = cfg["events"] if isinstance(cfg, dict) else cfg
        return cls((e["t"], PhaseAction.from_config(e["action"]))
                   for e in events)
