"""Engine selection: one config object for the oracle/fast-path toggles.

The engine grew five independent switches, each a class attribute flipped
ad hoc by tests and benchmarks: the simulator's SoA slab mirror
(``Simulator.soa_slab``), the scheduler's scalar fast path and its batch
threshold (``DreamScheduler.fast_path`` / ``soa_batch_min``), the fleet
clock's lazy peek heap (``FleetSimulator.lazy_peek``), and the router's
vectorized scoring arm (``ScoreDrivenRouter.vectorized``).  Every pair of
settings is bit-identical by construction (tests/test_vectorized_equiv.py
is the proof), so the only *meaningful* choice is a preset:

    ``engine="soa"``     all vectorized arms on (the default, fast)
    ``engine="scalar"``  every scalar oracle path (slow, for differential
                         testing and debugging)

:class:`EngineConfig` names that choice once and threads it through
``Simulator(engine=...)`` / ``FleetSimulator(engine=...)`` — which apply
it as *instance* attributes, leaving the class-attribute defaults (and
any test that monkeypatches them) untouched.  Per-feature overrides stay
possible for bisection::

    EngineConfig("soa", lazy_peek=False)   # SoA core, scan fleet clock

Flag-by-flag class-attribute flipping keeps working; the config is the
front door, not a new mechanism.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: preset name -> fully-resolved flag values
ENGINE_PRESETS: dict[str, dict] = {
    "soa": {"soa_slab": True, "fast_path": True, "soa_batch_min": 8,
            "lazy_peek": True, "vectorized_router": True},
    "scalar": {"soa_slab": False, "fast_path": False, "soa_batch_min": 8,
               "lazy_peek": False, "vectorized_router": False},
}


@dataclass(frozen=True)
class EngineConfig:
    """Engine preset plus optional per-feature overrides (None = preset).

    ``soa_slab``        SoA job slab + slab-stepping in the per-node core
    ``fast_path``       scheduler's memoized scalar fast path
    ``soa_batch_min``   ready-set size above which the scheduler batches
    ``lazy_peek``       fleet clock driven by the persistent peek heap
    ``vectorized_router`` router scores all nodes in one NumPy pass
    """

    engine: str = "soa"
    soa_slab: Optional[bool] = None
    fast_path: Optional[bool] = None
    soa_batch_min: Optional[int] = None
    lazy_peek: Optional[bool] = None
    vectorized_router: Optional[bool] = None

    def __post_init__(self):
        if self.engine not in ENGINE_PRESETS:
            raise ValueError(
                f"unknown engine preset {self.engine!r}; expected one of "
                f"{', '.join(sorted(ENGINE_PRESETS))}")

    @classmethod
    def make(cls, value: "EngineConfig | str | None"
             ) -> "Optional[EngineConfig]":
        """Coerce a constructor argument: None passes through (class-
        attribute behavior), a preset name becomes a bare config."""
        if value is None or isinstance(value, cls):
            return value
        return cls(engine=value)

    def resolve(self) -> dict:
        """Preset values with any explicit overrides applied."""
        out = dict(ENGINE_PRESETS[self.engine])
        for k in out:
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    # ------------------------------------------------------------- apply
    # Appliers set instance attributes only — class defaults stay intact.

    def apply_simulator(self, sim) -> None:
        """Pin the per-node engine arms.  Must run before the simulator
        builds its JobTable (``soa_slab`` gates that allocation)."""
        r = self.resolve()
        sim.soa_slab = r["soa_slab"]
        sched = sim.scheduler
        if hasattr(type(sched), "fast_path"):
            sched.fast_path = r["fast_path"]
        if hasattr(type(sched), "soa_batch_min"):
            sched.soa_batch_min = r["soa_batch_min"]

    def apply_fleet(self, fleet) -> None:
        """Pin the fleet-level arms (node simulators are configured per
        node via :meth:`apply_simulator` when the fleet creates them)."""
        r = self.resolve()
        fleet.lazy_peek = r["lazy_peek"]
        if hasattr(type(fleet.policy), "vectorized"):
            fleet.policy.vectorized = r["vectorized_router"]
