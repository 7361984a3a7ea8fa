"""The five RTMM workload scenarios of the paper's Table 3.

Historically this module hand-built each scenario; they now live in the
scenario engine's registry (``repro_torch.scenarios.registry``) as declarative
:class:`ScenarioBuilder` instances alongside user-registered and fuzzer-
generated scenarios.  This module keeps the original ``build_scenario`` /
``SCENARIOS`` API as a thin delegation layer so core callers and the
benchmarks are unaffected.
"""
from __future__ import annotations

from .types import Scenario


def build_scenario(name: str, cascade_prob: float = 0.5) -> Scenario:
    from ..scenarios import registry
    return registry.build(name, cascade_prob=cascade_prob)


def vr_gaming(cascade_prob: float = 0.5) -> Scenario:
    return build_scenario("VR_Gaming", cascade_prob)


def ar_call(cascade_prob: float = 0.5) -> Scenario:
    return build_scenario("AR_Call", cascade_prob)


def drone_outdoor(cascade_prob: float = 0.5) -> Scenario:
    return build_scenario("Drone_Outdoor", cascade_prob)


def drone_indoor(cascade_prob: float = 0.5) -> Scenario:
    return build_scenario("Drone_Indoor", cascade_prob)


def ar_social(cascade_prob: float = 0.5) -> Scenario:
    return build_scenario("AR_Social", cascade_prob)


SCENARIOS = {
    "VR_Gaming": vr_gaming,
    "AR_Call": ar_call,
    "Drone_Outdoor": drone_outdoor,
    "Drone_Indoor": drone_indoor,
    "AR_Social": ar_social,
}
