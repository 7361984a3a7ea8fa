"""Scenario engine: declarative builders, arrival processes, phase scripts,
trace record/replay, and a seeded scenario fuzzer.

This package is the single source of RTMM workload definitions: the five
Table-3 scenarios live in :mod:`.registry` (``repro_torch.core.workloads``
delegates here), arbitrary new scenarios compose via
:class:`.builder.ScenarioBuilder`, and the simulator / serving engine
consume the same :class:`.trace.Trace` format for exact replay.
"""
from .arrivals import (ArrivalProcess, BurstyOnOff, Diurnal, Periodic,
                       PeriodicJitter, Poisson, Triggered,
                       arrival_from_config, arrival_kinds)
from .builder import ModelEntry, ModelRef, ScenarioBuilder, ScenarioError
from .phases import (PhaseAction, PhaseScript, join, join_entry, leave,
                     scale_fps, set_fps, set_trigger_prob)
from .trace import (Trace, TraceRecorder, dumps, load_trace, loads,
                    save_trace)
from .fuzzer import (fuzz_many, fuzz_phase_script, fuzz_scenario,
                     signature)
from . import registry

__all__ = [
    "ArrivalProcess", "BurstyOnOff", "Diurnal", "Periodic", "PeriodicJitter",
    "Poisson", "Triggered", "arrival_from_config", "arrival_kinds",
    "ModelEntry", "ModelRef", "ScenarioBuilder", "ScenarioError",
    "PhaseAction", "PhaseScript", "join", "join_entry", "leave", "scale_fps",
    "set_fps", "set_trigger_prob",
    "Trace", "TraceRecorder", "dumps", "load_trace", "loads", "save_trace",
    "fuzz_many", "fuzz_phase_script", "fuzz_scenario", "signature",
    "registry",
]
