"""The port's simulator on its dynamic paths against the JAX package's, and
against itself: phase scripts, generative streams, supernet switching,
trace record and replay across the two packages, and the scalar oracle
against the vectorised engine inside the port.

Every comparison is exact (``tests/_torch_sim_parity.py``'s ``plain``).
"""
import importlib
import json
import warnings

import numpy as np
import pytest

import repro.core.costmodel as ref_cm
import repro_torch.core.costmodel as port_cm
from _torch_sim_parity import PACKAGES, SCENARIOS, SYSTEM, result_fields, run

SCN = {"ref": importlib.import_module("repro.scenarios"),
       "port": importlib.import_module("repro_torch.scenarios")}
SIM = {pkg: importlib.import_module(f"{core.__name__}.simulator")
       for pkg, (core, _) in PACKAGES.items()}


@pytest.fixture(autouse=True)
def _cold_caches():
    ref_cm.clear_table_cache()
    port_cm.clear_table_cache()


def _fuzzed(pkg: str, seed: int, duration_s: float):
    scn = SCN[pkg]
    b = scn.fuzz_scenario(seed)
    return b, scn.fuzz_phase_script(seed, b, duration_s)


@pytest.mark.parametrize("scheduler", ["FCFS", "Planaria", "dream_full"])
@pytest.mark.parametrize("seed", range(4))
def test_fuzzed_phase_script_run_equal(seed, scheduler):
    out = {}
    for pkg in PACKAGES:
        b, script = _fuzzed(pkg, seed, 3.0)
        kw = {} if scheduler == "Planaria" else {"phase_script": script}
        out[pkg] = result_fields(run(pkg, b.build(), scheduler,
                                     duration_s=3.0, seed=seed, **kw))
    assert out["port"] == out["ref"]


def _churn_script(pkg: str):
    """Every action kind on AR_Call: a stage joins, fps and trigger
    probability move, the head scales, a stage leaves."""
    scn = SCN[pkg]
    late = scn.ModelEntry(ref=scn.ModelRef("kws_res8", name="kws_late"),
                          fps=20.0, arrival={"kind": "poisson",
                                             "rate_scale": 1.5})
    return scn.PhaseScript([
        (0.4, scn.join(late)), (0.8, scn.set_fps("kws_res8", 25.0)),
        (1.2, scn.set_trigger_prob("translate_gnmt", 0.9)),
        (1.6, scn.scale_fps(1.5)), (2.0, scn.leave("kws_late"))])


@pytest.mark.parametrize("scheduler", ["FCFS", "Veltair", "dream_smartdrop",
                                       "dream_full"])
def test_every_phase_action_equal(scheduler):
    out = {pkg: run(pkg, "AR_Call", scheduler, duration_s=2.5,
                    phase_script=_churn_script(pkg)) for pkg in PACKAGES}
    assert result_fields(out["port"]) == result_fields(out["ref"])
    assert out["port"].stats.per_model["kws_late"].frames > 0


@pytest.mark.parametrize("predictor", [True, False])
@pytest.mark.parametrize("scenario", ["Chat_Assistant", "Voice_Agent"])
def test_generative_run_equal(scenario, predictor):
    """Autoregressive streams: token draws on their own generator, the
    length predictor on and off, the degradation ladder's variants."""
    out = {}
    for pkg, (core, _) in PACKAGES.items():
        out[pkg] = result_fields(core.run_sim(
            core.build_scenario(scenario, 0.9), SYSTEM, core.dream_full,
            duration_s=3.0, seed=1, genai_predictor=predictor))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("scheduler", ["dream_full", "dream_smartdrop"])
def test_supernet_variant_counts_at_cascade_099(scheduler):
    """``examples/supernet_switching.py``'s heavy load: which
    Once-for-All subnet DREAM-Full picked, frame by frame."""
    out = {}
    for pkg, (core, _) in PACKAGES.items():
        r = core.run_sim(core.build_scenario("AR_Social", 0.99), SYSTEM,
                         getattr(core, scheduler), duration_s=4.0)
        out[pkg] = (result_fields(r), r.variant_counts)
    assert out["port"][0] == out["ref"][0]
    picked = {k for k, v in out["port"][1].items() if k.startswith("ctx_ofa")}
    assert bool(picked) == (scheduler == "dream_full")


def _port_run(scenario: str, **kw):
    return result_fields(run("port", scenario, "dream_full", duration_s=2.0,
                             **kw))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scalar_engine_equals_soa_in_the_port(scenario, monkeypatch):
    """``EngineConfig("scalar")`` against ``"soa"`` (and the batch arm
    forced at every ready-set size), and the class flags flipped as
    ``tests/test_vectorized_equiv.py``'s ``force_scalar`` flips them."""
    core = PACKAGES["port"][0]
    soa = _port_run(scenario, engine="soa")
    assert _port_run(scenario, engine="scalar") == soa
    assert _port_run(scenario, engine=core.EngineConfig(
        "soa", soa_batch_min=1)) == soa
    assert _port_run(scenario) == soa
    with monkeypatch.context() as m:
        m.setattr(core.DreamScheduler, "fast_path", False)
        m.setattr(core.Simulator, "soa_slab", False)
        assert _port_run(scenario) == soa


def test_deprecated_soa_slab_argument_still_works():
    core = PACKAGES["port"][0]
    want = _port_run("AR_Social", engine="scalar")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = core.Simulator(core.build_scenario("AR_Social", 0.5), SYSTEM,
                             core.dream_full(), duration_s=2.0,
                             engine="scalar", soa_slab=True)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert sim.soa_slab is True
    assert result_fields(sim.run()) == want


def _record(pkg: str, case: str):
    """A live run recorded in package ``pkg``: its result, the trace's
    JSONL text, and its scenario."""
    core, _ = PACKAGES[pkg]
    if case == "fuzzed":
        b, script = _fuzzed(pkg, 2, 3.0)
        scenario, kw = b.build(), {"phase_script": script}
    else:
        scenario, kw = core.build_scenario(case, 0.9), {}
    sim = SIM[pkg].Simulator(scenario, SYSTEM, core.dream_full(),
                             duration_s=3.0, seed=5, record=True, **kw)
    return sim.run(), SCN[pkg].dumps(sim.trace), scenario


@pytest.mark.parametrize("case", ["fuzzed", "Chat_Assistant", "AR_Social"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_trace_replays_across_packages(writer, reader, case):
    """A run recorded in one package, written as JSONL, replays in the
    other (its arrivals, phase events and token counts fed back, none of
    its generators drawn) to the live run, every field; the two packages'
    traces are byte-equal."""
    live, text, _ = _record(writer, case)
    other_live, other_text, scenario = _record(reader, case)
    assert other_text == text
    assert result_fields(other_live) == result_fields(live)
    core, _ = PACKAGES[reader]
    replayed = SIM[reader].Simulator(
        scenario, SYSTEM, core.dream_full(), duration_s=3.0, seed=5,
        replay=SCN[reader].loads(text)).run()
    assert result_fields(replayed) == result_fields(live)
    kinds = {json.loads(line)["type"] for line in text.splitlines()}
    assert "arrival" in kinds
    assert ("tokens" in kinds) == (case == "Chat_Assistant")
    assert ("phase" in kinds) == (case == "fuzzed")


def test_replay_refuses_another_scenario():
    _, text, _ = _record("ref", "AR_Social")
    core, _ = PACKAGES["port"]
    with pytest.raises(ValueError):
        SIM["port"].Simulator(core.build_scenario("AR_Call"), SYSTEM,
                              core.dream_full(), duration_s=1.0,
                              replay=SCN["port"].loads(text))


def test_replay_draws_no_arrival_or_token_randomness():
    """The arrival and token streams stay apart from the path stream: a
    replayed run leaves both generators where they started."""
    sim_mod = SIM["port"]
    assert sim_mod._ARRIVAL_STREAM != sim_mod._TOKEN_STREAM
    core, _ = PACKAGES["port"]
    _, text, scenario = _record("port", "Chat_Assistant")
    sim = sim_mod.Simulator(scenario, SYSTEM, core.dream_full(),
                            duration_s=3.0, seed=5,
                            replay=SCN["port"].loads(text))
    sim.run()
    for rng, stream in ((sim.arrival_rng, sim_mod._ARRIVAL_STREAM),
                        (sim.token_rng, sim_mod._TOKEN_STREAM)):
        fresh = np.random.default_rng([5, stream])
        assert rng.random() == fresh.random()
