"""The port's discrete-event simulator, DREAM and the baselines against the
JAX package's, exactly: every ``SimResult`` field of each registered
scenario under each scheduler on 4K_1WS2OS, DREAM-Full on each of the
eight systems, and two seeds.

The two packages run the same numpy operations in the same order on their
own seeded generators, so the results are compared with ``==`` on
``tests/_torch_sim_parity.py``'s ``plain`` form (float bits, dict order).
"""
import pytest

import repro.core.costmodel as ref_cm
import repro_torch.core.costmodel as port_cm
from _torch_sim_parity import (SCENARIOS, SCHEDULERS, SYSTEM, PACKAGES, plain,
                               result_fields, run)

SYSTEMS = sorted(PACKAGES["ref"][0].SYSTEMS)


@pytest.fixture(autouse=True)
def _cold_caches():
    ref_cm.clear_table_cache()
    port_cm.clear_table_cache()


def _same(scenario, scheduler, **kw):
    ref = run("ref", scenario, scheduler, **kw)
    port = run("port", scenario, scheduler, **kw)
    assert result_fields(port) == result_fields(ref)
    assert port.summary() == ref.summary()
    return port


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_grid_equal(scenario, scheduler):
    r = _same(scenario, scheduler)
    # Planaria's simulator keeps no per-window record
    assert r.frames > 0
    assert len(r.windows) == (0 if scheduler == "Planaria" else 4)


@pytest.mark.parametrize("system", SYSTEMS)
def test_every_system_under_dream_full(system):
    _same("AR_Social", "dream_full", system=system)


@pytest.mark.parametrize("scheduler", ["FCFS", "Veltair", "Planaria",
                                       "dream_full"])
@pytest.mark.parametrize("seed", [0, 7])
def test_seeds(seed, scheduler):
    a = _same("Drone_Indoor", scheduler, seed=seed)
    b = run("port", "Drone_Indoor", scheduler, seed=seed)
    assert result_fields(a) == result_fields(b)


def test_seeds_differ():
    """Seeds 0 and 7 do draw different runs (so the test above compares
    two runs, not one)."""
    a = run("port", "Drone_Indoor", "dream_full", seed=0)
    b = run("port", "Drone_Indoor", "dream_full", seed=7)
    assert result_fields(a) != result_fields(b)


def test_windows_and_adaptivity_equal_over_a_longer_run():
    """DREAM-Full's (alpha, beta) probe over 6 s: each window's UXCost and
    candidate, and the scheduler's probe state at the end."""
    sims = {}
    for pkg, (core, _) in PACKAGES.items():
        sched = core.dream_full()
        sim = core.Simulator(core.build_scenario("AR_Call", 0.9), SYSTEM,
                             sched, duration_s=6.0, seed=2)
        sims[pkg] = (sim.run(), sched)
    (ref_r, ref_s), (port_r, port_s) = sims["ref"], sims["port"]
    assert result_fields(port_r) == result_fields(ref_r)
    assert len({(a, b) for _, _, a, b in port_r.windows}) > 1
    assert plain(port_s.adapt) == plain(ref_s.adapt)
