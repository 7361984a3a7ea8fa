"""Helpers of the simulator parity tests (``tests/test_torch_costmodel.py``,
``test_torch_scenarios.py``, ``test_torch_simulator.py``,
``test_torch_sim_replay.py``): the port's ``repro_torch.core`` and
``repro_torch.scenarios`` against the JAX package's ``repro.core`` and
``repro.scenarios``, compared exactly.

The two packages define their own classes, so a value of one never equals a
value of the other under ``==`` unless it is made of built-in types first:
``plain`` turns dataclasses, enums, numpy arrays and scalars into tuples of
built-ins that keep every float's bits, every dict's order and every type's
name.
"""
import dataclasses
import enum

import numpy as np

import repro.core as ref_core
import repro.core.baselines as ref_base
import repro_torch.core as port_core
import repro_torch.core.baselines as port_base

PACKAGES = {"ref": (ref_core, ref_base), "port": (port_core, port_base)}

#: the seven registered scenarios: the paper's five and the two generative
SCENARIOS = ("VR_Gaming", "AR_Call", "Drone_Outdoor", "Drone_Indoor",
             "AR_Social", "Chat_Assistant", "Voice_Agent")
#: every scheduler of the two packages, by the name it is run under
SCHEDULERS = ("FCFS", "StaticFCFS", "Veltair", "Planaria", "dream_mapscore",
              "dream_smartdrop", "dream_full")
SYSTEM = "4K_1WS2OS"


def plain(x):
    """``x`` as built-in values: the same for a value of either package
    exactly when the two are equal bit for bit."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return (type(x).__name__, x.tobytes())
    if isinstance(x, float):
        return ("float", x.hex())
    if isinstance(x, dict):
        return ("dict", tuple((plain(k), plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(plain(v) for v in x))
    if hasattr(x, "to_config"):
        return (type(x).__name__, plain(x.to_config()))
    return x


def result_fields(r) -> dict:
    """Every field of a ``SimResult`` the parity tests compare, in
    ``plain`` form."""
    return {name: plain(getattr(r, name)) for name in (
        "scenario", "system", "scheduler", "duration_s", "uxcost",
        "dlv_rate", "norm_energy", "frames", "drops", "aborts",
        "variant_counts", "windows", "acc_utilization",
        "pipeline_latency_s", "stats")}


def run(pkg: str, scenario, scheduler: str, system: str = SYSTEM,
        duration_s: float = 2.0, seed: int = 0, **kw):
    """One run of ``scheduler`` on ``scenario`` (a name, built at cascade
    probability 0.5, or a package's ``Scenario``) in package ``pkg``."""
    core, base = PACKAGES[pkg]
    if isinstance(scenario, str):
        scenario = core.build_scenario(scenario, 0.5)
    if scheduler == "Planaria":
        return core.run_planaria(scenario, system, duration_s=duration_s,
                                 seed=seed, **kw)
    factory = {"FCFS": base.FCFSScheduler,
               "StaticFCFS": base.StaticFCFSScheduler,
               "Veltair": base.VeltairLikeScheduler}.get(scheduler)
    if factory is None:
        factory = getattr(core, scheduler)
    return core.run_sim(scenario, system, factory, duration_s=duration_s,
                        seed=seed, **kw)
