"""The port's scenario engine (``repro_torch.scenarios``: builder, phases,
registry, fuzzer, trace) against the JAX package's ``repro.scenarios``,
exactly: the same registry, the same scenarios field by field, the same
phase scripts and fuzzed scenarios, and traces that load across the two
packages with byte-equal ``dumps``.
"""
import json

import numpy as np
import pytest

import repro.scenarios as ref_scn
import repro_torch.scenarios as port_scn
from _torch_sim_parity import PACKAGES, SCENARIOS, plain
from repro import serving as ref_serving
from repro.scenarios import registry as ref_registry
from repro_torch import serving as port_serving
from repro_torch.scenarios import registry as port_registry

SCN = {"ref": ref_scn, "port": port_scn}


def test_registry_names_equal():
    assert port_registry.names() == ref_registry.names()
    assert set(SCENARIOS) == set(port_registry.names())
    assert list(PACKAGES["port"][0].SCENARIOS) == list(
        PACKAGES["ref"][0].SCENARIOS)
    with pytest.raises(port_scn.ScenarioError, match="unknown scenario"):
        port_registry.get("Nope")


@pytest.mark.parametrize("cascade_prob", [0.2, 0.5, 0.99])
@pytest.mark.parametrize("name", SCENARIOS)
def test_registered_scenario_built_equal(name, cascade_prob):
    """Every ``ModelSpec`` of the built scenario (graph, fps, dependency,
    trigger probability, deadline, arrival), the builder's config, and the
    ``core.workloads`` front door."""
    ref_b = ref_registry.get(name, cascade_prob=cascade_prob)
    port_b = port_registry.get(name, cascade_prob=cascade_prob)
    assert port_b.to_config() == ref_b.to_config()
    ref_s, port_s = ref_b.build(), port_b.build()
    assert plain(port_s) == plain(ref_s)
    for i, spec in enumerate(port_s.models):
        assert port_s.dependents_of(spec.model.name) == ref_s.dependents_of(
            spec.model.name)
        assert port_s.is_chain_tail(i) == ref_s.is_chain_tail(i)
        assert spec.deadline == ref_s.models[i].deadline
    core = PACKAGES["port"][0]
    assert plain(core.build_scenario(name, cascade_prob)) == plain(ref_s)
    again = port_scn.ScenarioBuilder.from_config(port_b.to_config())
    assert plain(again.build()) == plain(port_s)


def _actions(scn):
    entry = scn.ModelEntry(ref=scn.ModelRef("kws_res8", name="kws_late"),
                           fps=20.0, arrival={"kind": "poisson",
                                              "rate_scale": 1.5})
    return [scn.set_fps("kws_res8", 12.0), scn.scale_fps(1.7),
            scn.scale_fps(0.5, ["kws_res8"]),
            scn.set_trigger_prob("translate_gnmt", 0.25),
            scn.leave("kws_res8"), scn.join(entry)]


def test_phase_scripts_equal():
    """Each action kind, a script's order and its config round trip, and
    ``join_entry``."""
    scripts = {}
    for pkg, scn in SCN.items():
        acts = _actions(scn)
        script = scn.PhaseScript([(1.5, acts[0]), (0.25, acts[1])])
        for k, a in enumerate(acts[2:]):
            script.at(0.5 + 0.3 * k, a)
        back = scn.PhaseScript.from_config(script.to_config())
        assert back.to_config() == script.to_config() and len(back) == 6
        scripts[pkg] = (script.to_config(), plain(list(script)),
                        plain(scn.join_entry(acts[-1])))
    assert scripts["port"] == scripts["ref"]
    for pkg, scn in SCN.items():
        for bad in (lambda: scn.set_fps("m", 0.0),
                    lambda: scn.scale_fps(-1.0),
                    lambda: scn.set_trigger_prob("m", 1.5)):
            with pytest.raises(ValueError):
                bad()


@pytest.mark.parametrize("kw", [{}, {"cascade_prob": 1.0, "max_depth": 3},
                                {"max_pipelines": 6}],
                         ids=["default", "deep", "wide"])
def test_fuzzer_signatures_equal(kw):
    """``fuzz_scenario`` over 24 seeds: the same ``signature``, the same
    built scenario, and the same ``fuzz_phase_script``; ``fuzz_many``."""
    for seed in range(24):
        ref_b = ref_scn.fuzz_scenario(seed, **kw)
        port_b = port_scn.fuzz_scenario(seed, **kw)
        assert port_scn.signature(port_b) == ref_scn.signature(ref_b)
        assert plain(port_b.build()) == plain(ref_b.build())
        for duration in (2.0, 4.0):
            assert (port_scn.fuzz_phase_script(seed, port_b, duration)
                    .to_config()
                    == ref_scn.fuzz_phase_script(seed, ref_b, duration)
                    .to_config())
    assert ([port_scn.signature(b) for b in port_scn.fuzz_many(6, 40, **kw)]
            == [ref_scn.signature(b) for b in ref_scn.fuzz_many(6, 40, **kw)])


def test_builder_validation_matches():
    for pkg, scn in SCN.items():
        b = scn.ScenarioBuilder("bad").model("kws_res8", 10.0, name="a")
        b.model("gnmt", 10.0, name="b", depends_on="zzz")
        with pytest.raises(scn.ScenarioError, match="depends on"):
            b.build()
        with pytest.raises(scn.ScenarioError, match="no models"):
            scn.ScenarioBuilder("empty").build()
        g = scn.ScenarioBuilder("g").add_genai_stream(
            2.0, name="llm", kwargs={"max_new_tokens": 8})
        assert g.validate() == ["llm"]


def _recorded(pkg: str, scenario: str = "Chat_Assistant"):
    """A trace recorded by package ``pkg``'s simulator: arrivals, a phase
    event, generated token counts."""
    core, _ = PACKAGES[pkg]
    from importlib import import_module
    sim_mod = import_module(f"{core.__name__}.simulator")
    scn = SCN[pkg]
    script = scn.PhaseScript([(0.6, scn.scale_fps(1.5))])
    sim = sim_mod.Simulator(core.build_scenario(scenario, 0.5), "4K_1WS2OS",
                            core.dream_full(), duration_s=1.2, seed=3,
                            phase_script=script, record=True)
    sim.run()
    return sim.trace


def test_trace_recorded_by_either_package_is_byte_equal():
    texts = {pkg: SCN[pkg].dumps(_recorded(pkg)) for pkg in SCN}
    assert texts["port"] == texts["ref"]
    kinds = {json.loads(line)["type"] for line in texts["port"].splitlines()}
    assert {"meta", "arrival", "phase", "tokens"} <= kinds


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_trace_loads_across_packages(writer, reader, tmp_path):
    """A trace saved by one package loads in the other: the same meta,
    events, arrivals, phases and token counts, and ``dumps`` gives the
    bytes back."""
    trace = _recorded(writer)
    path = SCN[writer].save_trace(trace, str(tmp_path / "t.jsonl"))
    text = open(path).read()
    got = SCN[reader].load_trace(path)
    assert got.meta == trace.meta and got.events == trace.events
    assert got.arrivals == trace.arrivals and got.phases == trace.phases
    assert got.arrivals_by_model() == trace.arrivals_by_model()
    assert got.tokens_by_model() == trace.tokens_by_model()
    assert SCN[reader].dumps(got) == text


def test_trace_recorder_api_equal():
    out = {}
    for pkg, scn in SCN.items():
        rec = scn.TraceRecorder({"scenario": "x", "seed": 1})
        rec.arrival(0.125, "a")
        rec.phase(0.5, {"kind": "scale_fps", "factor": 2.0, "models": None})
        rec.tokens(0.25, "llm", 7)
        rec.preempt(0.3, "llm", 1)
        out[pkg] = scn.dumps(rec.trace())
        with pytest.raises(ValueError, match="unknown type"):
            scn.loads('{"type": "nope"}\n')
        with pytest.raises(ValueError, match="unsupported trace version"):
            scn.loads('{"type": "meta", "version": 9}\n')
    assert out["port"] == out["ref"]


def test_trace_replay_queue_unchanged_on_the_ports_own_trace():
    """The serving engine's ``TraceReplayQueue`` fed a trace the port's
    simulator recorded gives what the JAX package's queue gives on the
    JAX simulator's trace: the same head requests, drained once."""
    traces = {pkg: _recorded(pkg, "AR_Call") for pkg in SCN}
    queues = []
    for pkg, mod in (("ref", ref_serving), ("port", port_serving)):
        q = mod.TraceReplayQueue(clock=lambda: 0.0, trace=traces[pkg])
        q.add_stream("kws_res8", fps=15, batch=1, seq=4, vocab=8)
        q.add_stream("translate_gnmt", fps=15, batch=1, seq=4, vocab=8,
                     depends_on="kws_res8", trigger_prob=1.0)
        queues.append(q)
    rq, pq = queues
    for now in (0.4, 1.2):
        rout, pout = rq.poll(now), pq.poll(now)
        assert len(rout) == len(pout)
        for a, b in zip(rout, pout):
            assert (a.model, a.arrival, a.deadline) == (b.model, b.arrival,
                                                        b.deadline)
            np.testing.assert_array_equal(a.tokens, b.tokens)
    assert [r.arrival for r in pq.pending] == traces["port"].arrivals_by_model()[
        "kws_res8"]
    assert pq.poll(2.0) == []
