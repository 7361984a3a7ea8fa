"""Seeded scenario fuzzer: sample valid random RTMM scenarios.

For stress sweeps the registry's hand-built scenarios are not enough — the
scheduler should hold up on *any* plausible combination of pipelines, FPS
targets, cascades, and arrival processes.  ``fuzz_scenario(seed)`` draws a
random-but-valid :class:`ScenarioBuilder`; identical seeds yield identical
scenarios, and every scenario serializes (``to_config``) so interesting
samples can be pinned as regression cases.

``fuzz_phase_script(seed, builder, duration_s)`` optionally layers a random
workload shift (FPS rescale / cascade swing / model departure) on top, to
stress the online adaptivity engine.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .arrivals import (ArrivalProcess, BurstyOnOff, Diurnal, Periodic,
                       PeriodicJitter, Poisson)
from .builder import ModelRef, ScenarioBuilder
from . import phases

#: (zoo builder key, builder kwargs) pools.  Heads run standalone streams;
#: children hang off a parent via a cascade dependency.
HEAD_POOL: tuple[tuple[str, dict], ...] = (
    ("fbnet_c", {}),
    ("ssd_mnv2", {"res": 512}),
    ("ssd_mnv2", {"res": 640}),
    ("skipnet", {"res": 448}),
    ("trailnet", {}),
    ("sosnet", {"patches": 144}),
    ("rapid_rl", {}),
    ("googlenet_car", {}),
    ("focal_depth", {}),
    ("ed_tcn", {}),
    ("kws_res8", {}),
    ("ofa", {}),
)
CHILD_POOL: tuple[tuple[str, dict], ...] = (
    ("handpose", {"res": 320}),
    ("handpose", {"res": 288}),
    ("gnmt", {}),
    ("vgg_voxceleb", {}),
    ("sosnet", {"patches": 196}),
    ("googlenet_car", {}),
)
FPS_CHOICES = (5.0, 10.0, 15.0, 30.0, 60.0)


def _sample_arrival(rng: np.random.Generator) -> Optional[ArrivalProcess]:
    kind = rng.integers(0, 6)
    if kind == 0:
        return None                       # legacy strict-periodic default
    if kind == 1:
        return Periodic(phase_frac=round(float(rng.uniform(0.0, 1.0)), 3))
    if kind == 2:
        return PeriodicJitter(jitter=round(float(rng.uniform(0.05, 0.4)), 3))
    if kind == 3:
        return Poisson(rate_scale=round(float(rng.uniform(0.5, 2.0)), 3))
    if kind == 4:
        return BurstyOnOff(
            on_s=round(float(rng.uniform(0.2, 1.0)), 3),
            off_s=round(float(rng.uniform(0.2, 1.0)), 3),
            burst_factor=round(float(rng.uniform(1.5, 4.0)), 3))
    return Diurnal(amplitude=round(float(rng.uniform(0.3, 0.95)), 3),
                   day_s=round(float(rng.uniform(2.0, 12.0)), 3))


def fuzz_scenario(seed: int, max_pipelines: int = 4,
                  cascade_prob: float = 0.5,
                  max_depth: int = 2) -> ScenarioBuilder:
    """Draw one valid random scenario (1..max_pipelines pipelines).

    ``cascade_prob`` is the probability each pipeline grows a cascade
    child (1.0 makes every pipeline a cascade — the population the fleet
    stage-split benchmarks want); ``max_depth`` bounds the cascade chain
    length (2 = head + child, the historical shape).  Defaults consume
    exactly the seed fuzzer's RNG stream, so existing seeds reproduce
    their historical scenarios bit-for-bit.
    """
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, max_pipelines + 1))
    b = ScenarioBuilder(f"fuzz_{seed}")
    for p in range(n):
        hb, hkw = HEAD_POOL[int(rng.integers(0, len(HEAD_POOL)))]
        head = f"{hb}_{p}"
        b.model(ModelRef(hb, name=head, kwargs=dict(hkw)),
                fps=float(FPS_CHOICES[int(rng.integers(0, len(FPS_CHOICES)))]),
                arrival=_sample_arrival(rng))
        parent, depth = head, 1
        while depth < max_depth and rng.random() < cascade_prob:
            cb, ckw = CHILD_POOL[int(rng.integers(0, len(CHILD_POOL)))]
            child = f"{cb}_{p}c" if depth == 1 else f"{cb}_{p}c{depth}"
            b.model(ModelRef(cb, name=child, kwargs=dict(ckw)),
                    fps=float(FPS_CHOICES[int(rng.integers(0, len(FPS_CHOICES)))]),
                    depends_on=parent,
                    trigger_prob=round(float(rng.uniform(0.2, 1.0)), 3))
            parent, depth = child, depth + 1
    b.validate()
    return b


def fuzz_phase_script(seed: int, builder: ScenarioBuilder,
                      duration_s: float) -> phases.PhaseScript:
    """A random mid-run workload shift for the given scenario."""
    rng = np.random.default_rng(seed + 0x5EED)
    t = round(float(rng.uniform(0.3, 0.7)) * duration_s, 3)
    heads = [e.model_name for e in builder.entries if e.depends_on is None]
    children = [e.model_name for e in builder.entries
                if e.depends_on is not None]
    choices = ["scale_fps"]
    if children:
        choices.append("set_trigger_prob")
    if len(heads) > 1:
        choices.append("leave")
    kind = choices[int(rng.integers(0, len(choices)))]
    if kind == "scale_fps":
        action = phases.scale_fps(round(float(rng.uniform(0.5, 2.5)), 3))
    elif kind == "set_trigger_prob":
        action = phases.set_trigger_prob(
            children[int(rng.integers(0, len(children)))],
            round(float(rng.uniform(0.0, 1.0)), 3))
    else:
        action = phases.leave(heads[int(rng.integers(0, len(heads)))])
    return phases.PhaseScript([(t, action)])


def signature(builder: ScenarioBuilder) -> str:
    """Canonical string identity of a scenario (for dedup in sweeps)."""
    cfg = builder.to_config()
    cfg.pop("name", None)       # identity is the structure, not the label
    return json.dumps(cfg, sort_keys=True)


def fuzz_many(n: int, seed0: int = 0, **kw) -> list[ScenarioBuilder]:
    return [fuzz_scenario(seed0 + i, **kw) for i in range(n)]
