"""Declarative scenario builder: compose RTMM pipelines from zoo models.

A scenario is described as data — zoo model references, FPS targets,
cascade dependencies, and optional arrival processes — then materialized
into the immutable :class:`repro_torch.core.types.Scenario` the simulator and
serving engine consume.  Because the description is plain data, scenarios
round-trip through JSON (``to_config`` / ``from_config``), which is what
the registry, the fuzzer, phase-script ``join`` actions, and the fleet's
stream sharding build on.

Invariants enforced by ``validate()``: model names are unique within a
scenario, FPS targets are positive, trigger probabilities lie in [0, 1],
and cascade dependencies only reference *earlier* entries (forward-only —
which is why a pipeline can always be placed head first, and why
cross-pipeline dependencies cannot exist).

    scn = (ScenarioBuilder("kitchen_sink")
           .model("ssd_mnv2", fps=30, name="det", kwargs={"res": 640})
           .model("handpose", fps=30, name="pose", depends_on="det",
                  trigger_prob=0.7)
           .model("kws_res8", fps=15, name="kws",
                  arrival=Poisson())
           .build())
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from ..core.types import ModelGraph, ModelSpec, Scenario
from ..core import zoo

from .arrivals import ArrivalProcess, arrival_from_config


class ScenarioError(ValueError):
    """Raised when a scenario description is inconsistent."""


@dataclass(frozen=True)
class ModelRef:
    """A serializable pointer to a zoo model builder.

    ``builder`` is a key of ``zoo.ZOO_BUILDERS``; ``name`` overrides the
    instance name (two pipelines may use the same architecture under
    different names); ``kwargs`` forwards builder parameters (res, patches,
    skip_prob, ...).
    """

    builder: str
    name: Optional[str] = None
    kwargs: dict = field(default_factory=dict)

    def build(self) -> ModelGraph:
        if self.builder not in zoo.ZOO_BUILDERS:
            raise ScenarioError(f"unknown zoo builder: {self.builder!r}")
        # Memoized: one structural build per (builder, kwargs), renamed via
        # dataclasses.replace so the frozen layers tuple keeps one identity
        # fleet-wide (that identity is the costmodel fast-cache key).
        return zoo.build_cached(self.builder, self.name, self.kwargs)

    def to_config(self) -> dict:
        return {"builder": self.builder, "name": self.name,
                "kwargs": dict(self.kwargs)}

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelRef":
        return cls(builder=cfg["builder"], name=cfg.get("name"),
                   kwargs=dict(cfg.get("kwargs", {})))


@dataclass
class ModelEntry:
    """One pipeline stage of a scenario under construction."""

    ref: Union[ModelRef, ModelGraph]
    fps: float
    depends_on: Optional[str] = None
    trigger_prob: float = 0.5
    deadline_factor: Optional[float] = None
    arrival: Union[ArrivalProcess, dict, None] = None

    @property
    def model_name(self) -> str:
        if isinstance(self.ref, ModelGraph):
            return self.ref.name
        if self.ref.name is not None:
            return self.ref.name
        return self.ref.build().name

    def to_spec(self) -> ModelSpec:
        graph = self.ref if isinstance(self.ref, ModelGraph) else self.ref.build()
        arrival = self.arrival
        if isinstance(arrival, dict):
            arrival = arrival_from_config(arrival)
        return ModelSpec(
            model=graph,
            fps=self.fps,
            depends_on=self.depends_on,
            trigger_prob=self.trigger_prob,
            deadline_s=None if self.deadline_factor is None
            else self.deadline_factor / self.fps,
            arrival=arrival,
        )

    def to_config(self) -> dict:
        if isinstance(self.ref, ModelGraph):
            raise ScenarioError(
                f"entry {self.ref.name!r} wraps a raw ModelGraph; only "
                "ModelRef-based entries serialize to config")
        arrival = self.arrival
        if isinstance(arrival, ArrivalProcess):
            arrival = arrival.to_config()
        return {"model": self.ref.to_config(), "fps": self.fps,
                "depends_on": self.depends_on,
                "trigger_prob": self.trigger_prob,
                "deadline_factor": self.deadline_factor,
                "arrival": arrival}

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelEntry":
        return cls(ref=ModelRef.from_config(cfg["model"]), fps=cfg["fps"],
                   depends_on=cfg.get("depends_on"),
                   trigger_prob=cfg.get("trigger_prob", 0.5),
                   deadline_factor=cfg.get("deadline_factor"),
                   arrival=cfg.get("arrival"))


class ScenarioBuilder:
    """Fluent, validating builder for RTMM scenarios."""

    def __init__(self, name: str):
        self.name = name
        self.entries: list[ModelEntry] = []

    def model(self, ref: Union[str, ModelRef, ModelGraph], fps: float, *,
              name: Optional[str] = None, kwargs: Optional[dict] = None,
              depends_on: Optional[str] = None, trigger_prob: float = 0.5,
              deadline_factor: Optional[float] = None,
              arrival: Union[ArrivalProcess, dict, None] = None,
              ) -> "ScenarioBuilder":
        """Append one pipeline stage.  ``ref`` is a zoo builder key, a
        prebuilt :class:`ModelRef`, or (non-serializable) a raw ModelGraph."""
        if isinstance(ref, str):
            ref = ModelRef(builder=ref, name=name, kwargs=dict(kwargs or {}))
        elif name is not None or kwargs is not None:
            raise ScenarioError("name/kwargs only apply to zoo-key refs")
        self.entries.append(ModelEntry(
            ref=ref, fps=fps, depends_on=depends_on, trigger_prob=trigger_prob,
            deadline_factor=deadline_factor, arrival=arrival))
        return self

    def add_genai_stream(self, fps: float, *, name: Optional[str] = None,
                         kwargs: Optional[dict] = None,
                         depends_on: Optional[str] = None,
                         trigger_prob: float = 0.5,
                         deadline_factor: Optional[float] = None,
                         arrival: Union[ArrivalProcess, dict, None] = None,
                         ) -> "ScenarioBuilder":
        """Append an autoregressive chat_llm stage (prefill + stochastic
        per-job decode loop).  Thin sugar over ``model("chat_llm", ...)``;
        ``kwargs`` forwards chat_llm builder parameters (d_model,
        prompt_tokens, max_new_tokens, token_mean, ...)."""
        return self.model("chat_llm", fps, name=name, kwargs=kwargs,
                          depends_on=depends_on, trigger_prob=trigger_prob,
                          deadline_factor=deadline_factor, arrival=arrival)

    # ------------------------------------------------------------ validate
    def validate(self) -> list[str]:
        """All model names for a valid scenario (raises ScenarioError)."""
        if not self.entries:
            raise ScenarioError(f"scenario {self.name!r} has no models")
        names: list[str] = []
        for e in self.entries:
            n = e.model_name
            if n in names:
                raise ScenarioError(f"duplicate model name {n!r}")
            if e.fps <= 0:
                raise ScenarioError(f"{n!r}: fps must be positive, got {e.fps}")
            if not (0.0 <= e.trigger_prob <= 1.0):
                raise ScenarioError(
                    f"{n!r}: trigger_prob {e.trigger_prob} outside [0, 1]")
            if e.depends_on is not None and e.depends_on not in names:
                raise ScenarioError(
                    f"{n!r} depends on {e.depends_on!r}, which is not an "
                    "earlier model of the scenario")
            names.append(n)
        return names

    # --------------------------------------------------------------- build
    def build(self) -> Scenario:
        self.validate()
        return Scenario(name=self.name,
                        models=tuple(e.to_spec() for e in self.entries))

    # ----------------------------------------------------------- serialize
    def to_config(self) -> dict:
        self.validate()
        return {"name": self.name,
                "models": [e.to_config() for e in self.entries]}

    @classmethod
    def from_config(cls, cfg: dict) -> "ScenarioBuilder":
        b = cls(cfg["name"])
        b.entries = [ModelEntry.from_config(m) for m in cfg["models"]]
        return b
