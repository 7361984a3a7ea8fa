"""The modules under the port's fleet simulator against the JAX package's:
``repro_torch.cluster.{slo,builder,trace}`` and ``node.FleetNode`` against
``repro.cluster``'s, driven through the same calls on the same inputs.

Every comparison is exact (``plain`` from ``tests/_torch_sim_parity.py``
keeps float bits, dict order and type names); an error must be raised by
both packages, with the same class name and message.
"""
import json
import warnings

import numpy as np
import pytest

import repro.cluster as ref_cluster
import repro.core as ref_core
import repro.scenarios as ref_scen
import repro_torch.cluster as port_cluster
import repro_torch.core as port_core
import repro_torch.scenarios as port_scen
from _torch_sim_parity import SCENARIOS, plain, result_fields

PKGS = {"ref": (ref_cluster, ref_core, ref_scen),
        "port": (port_cluster, port_core, port_scen)}


def both(fn):
    """``fn(cluster, core, scenarios)`` in each package, as built-in values;
    an exception becomes its class name and message."""
    out = []
    for cl, co, sc in PKGS.values():
        try:
            out.append(("ok", plain(fn(cl, co, sc))))
        except Exception as e:                      # noqa: BLE001
            out.append(("raised", type(e).__name__, str(e)))
    return out


def assert_equal(fn):
    ref, port = both(fn)
    assert ref == port
    return ref


# ---------------------------------------------------------------------------
# slo: classes, config forms, the controller and the estimator
# ---------------------------------------------------------------------------

def test_tier_constants_equal():
    got = assert_equal(lambda cl, co, sc: (
        cl.TIER_GUARANTEED, cl.TIER_STANDARD, cl.TIER_BEST_EFFORT,
        cl.TIER_DEFAULTS, cl.DEFAULT_SLO))
    assert got[0] == "ok"


@pytest.mark.parametrize("args", [(7, 1.0, 1.0), (1, 0.0, 1.0),
                                  (1, 1.0, -1.0), (0, 1.5, 4.0),
                                  (2, 8.0, 0.5)])
def test_slo_class_validation_equal(args):
    tier, budget, prio = args
    got = assert_equal(lambda cl, co, sc: cl.SLOClass(
        tier=tier, budget_factor=budget, priority=prio).to_config())
    assert got[0] == ("raised" if args[:2] in ((7, 1.0), (1, 0.0))
                      or prio < 0 else "ok")


@pytest.mark.parametrize("cfg", [
    None, 0, 1, 2, {"tier": 2, "budget_factor": 8.0},
    {"tier": 0, "priority": 9.0}, "class", True, 9, {"tier": "x"},
    {"budget_factor": 1.0}, "gold"], ids=str)
def test_slo_from_config_equal(cfg):
    def go(cl, co, sc):
        c = (cl.SLOClass(tier=1, budget_factor=3.0, priority=2.0)
             if cfg == "class" else cfg)
        got = cl.slo_from_config(c)
        return got, got.to_config(), got is cl.DEFAULT_SLO
    assert_equal(go)


def test_admission_controller_make_and_errors_equal():
    cfg = {"t_degrade": 0.50, "t_promote": 0.35, "t_reject": 0.62,
           "max_actions": 6, "admit_level": 2}
    for arg in (None, False, True, cfg, "always"):
        assert_equal(lambda cl, co, sc: (
            lambda ac: ac if ac is None else ac.to_config())(
                cl.AdmissionController.make(arg)))
    assert_equal(lambda cl, co, sc: cl.AdmissionController(
        t_promote=0.9, t_degrade=0.5))
    assert_equal(lambda cl, co, sc: (
        lambda ac: cl.AdmissionController.make(ac) is ac)(
            cl.AdmissionController()))


def _window(cl, rng, t0):
    n = int(rng.integers(1, 5))
    return cl.TelemetryWindow(
        t0=t0, t1=t0 + 0.5, frames=int(rng.integers(0, 40)),
        violated=int(rng.integers(0, 10)), dlv_rate=float(rng.random()),
        uxcost=float(rng.random() * 3), node_dlv={
            i: float(rng.random() * 0.5) for i in range(n)},
        node_frames={i: int(rng.integers(0, 20)) for i in range(n)},
        backlog_p50=float(rng.random()), backlog_p90=float(rng.random() * 2),
        backlog_max=float(rng.random() * 3), migrations=0, xfer_j=0.0,
        stream_uxcost={}, pipe_frames=int(rng.integers(0, 6)),
        pipe_latency_s=float(rng.random() * 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_controller_drive_equal(seed):
    """register/forget, on_window, pressure, admit and plan on one seeded
    sequence: the same pressures, decisions, plans and attributed terms."""
    def go(cl, co, sc):
        rng = np.random.default_rng(seed)
        ac = cl.AdmissionController(t_degrade=0.6, t_promote=0.4,
                                    t_reject=0.9, max_actions=3,
                                    admit_level=2)
        log = []
        for step in range(24):
            if step % 3 == 0:
                ac.register(step, cl.TIER_DEFAULTS[step % 3],
                            head_period_s=float(0.02 + rng.random() * 0.1))
            if step % 7 == 6:
                ac.forget(step - 6)
            utils = [float(u) for u in rng.random(int(rng.integers(1, 5)))
                     * 1.4]
            log.append(ac.on_window(_window(cl, rng, 0.5 * step), utils))
            log.append(ac.pressure(utils))
            for tier in range(3):
                log.append(ac.admit(cl.TIER_DEFAULTS[tier],
                                    int(rng.integers(0, 4)), utils))
            states = [cl.StreamState(
                sid=i, tier=int(rng.integers(0, 3)),
                priority=float(rng.integers(1, 5)),
                level=int(rng.integers(0, 3)), max_level=3,
                load=float(rng.random())) for i in range(6)]
            log.append(ac.plan(states))
            log.append(dict(ac.last_terms))
            log.append(ac.last_pressure)
        return log, ac.to_config()
    assert_equal(go)


def test_load_estimator_equal():
    def go(cl, co, sc):
        rng = np.random.default_rng(4)
        est = cl.LoadEstimator(alpha=0.3, horizon=3.0)
        out = [est.predict()]
        for u in rng.random(40) * 1.5:
            est.observe(float(u))
            out.append((est.predict(), est.level))
        return out
    assert_equal(go)


# ---------------------------------------------------------------------------
# builder: every fuzz spec, every event, split_pipelines
# ---------------------------------------------------------------------------

def _spec(cl, name):
    """The fuzz populations of tests/test_fuzz_spec.py, the genai mix of
    tests/test_vectorized_equiv.py, and one with every sub-spec at once."""
    return {
        "plain": lambda: cl.FuzzSpec(n_streams=12, seed=3),
        "scaled_window": lambda: cl.FuzzSpec(n_streams=10, seed=7, t0=0.1,
                                             t1=0.8, fps_scale=0.4),
        "cascades": lambda: cl.FuzzSpec(
            n_streams=8, seed=11, deterministic_arrivals=True,
            cascade=cl.CascadeFuzz(prob=1.0, max_depth=3, only=True,
                                   max_pipelines=2)),
        "lifecycle": lambda: cl.FuzzSpec(
            n_streams=14, seed=5, lifecycle=cl.LifecycleFuzz(
                depart_frac=0.5, rejoin_frac=0.4, t0=0.4, t1=0.9)),
        "tiered_supernet": lambda: cl.FuzzSpec(
            n_streams=16, seed=9, fps_scale=0.55,
            deterministic_arrivals=True,
            slo=cl.SLOFuzz(tier_mix=(1.0, 2.0, 2.0), supernet_frac=0.5)),
        "genai": lambda: cl.FuzzSpec(
            n_streams=18, seed=3, t1=0.5, fps_scale=0.5,
            deterministic_arrivals=True, genai=cl.GenAIFuzz(frac=0.34)),
        "everything": lambda: cl.FuzzSpec(
            n_streams=20, seed=21, t0=0.05, t1=0.6, fps_scale=0.7,
            cascade=cl.CascadeFuzz(prob=0.6, max_depth=2),
            lifecycle=cl.LifecycleFuzz(depart_frac=0.4, rejoin_frac=0.5),
            slo=cl.SLOFuzz(tier_mix=(1.0, 1.0, 3.0), supernet_frac=0.25),
            genai=cl.GenAIFuzz(frac=0.2)),
    }[name]()


SPEC_NAMES = ("plain", "scaled_window", "cascades", "lifecycle",
              "tiered_supernet", "genai", "everything")


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_fuzz_streams_population_equal(name):
    def go(cl, co, sc):
        b = cl.FleetScenarioBuilder(f"fz_{name}")
        b.node("4K_1WS2OS")
        b.node("8K_2OS", at=0.2)
        sids = b.fuzz_streams(_spec(cl, name))
        scn = b.build()
        return sids, scn, scn.n_nodes, scn.n_streams
    got = assert_equal(go)
    assert got[0] == "ok"


def test_fuzz_streams_legacy_form_equal():
    """The deprecated keyword form warns once in each package and builds
    the population of the equivalent spec."""
    def go(cl, co, sc):
        b = cl.FleetScenarioBuilder("legacy")
        b.node("4K_2WS")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            b.fuzz_streams(8, 11, cascade_prob=1.0, max_depth=3,
                           cascades_only=True, max_pipelines=2,
                           deterministic_arrivals=True)
        assert [x.category for x in w] == [DeprecationWarning]
        return b.build()
    assert_equal(go)
    assert_equal(lambda cl, co, sc: cl.FleetScenarioBuilder("x")
                 .fuzz_streams(4))
    assert_equal(lambda cl, co, sc: cl.FleetScenarioBuilder("x")
                 .fuzz_streams(cl.FuzzSpec(n_streams=4, seed=0), seed=1))


def _hand_built(cl, sc):
    b = cl.FleetScenarioBuilder("hand")
    n0 = b.node("4K_2WS")
    n1 = b.node("8K_1OS2WS")
    n2 = b.node("4K_2OS", at=0.3)
    b.node_drain(n0, at=0.6)
    b.node_leave(n1, at=0.9)
    reg = sc.registry.get("AR_Call")
    sids = b.add_scenario(reg, at=0.1)
    s = b.add_stream([{"model": {"builder": "kws_res8", "name": "kws",
                                 "kwargs": {}}, "fps": 20.0}],
                     at=0.2, slo={"tier": 2, "budget_factor": 6.0})
    b.depart(s, at=0.5)
    b.rejoin(s, at=0.7)
    b.phase(sc.scale_fps(2.0), at=0.4, sids=sids[:2])
    b.phase({"kind": "scale_fps", "factor": 0.5, "models": None}, at=0.8)
    return b, (n0, n1, n2, sids, s)


def test_builder_events_and_roundtrip_equal():
    def go(cl, co, sc):
        b, ids = _hand_built(cl, sc)
        scn = b.build()
        back = cl.FleetScenario.from_config(
            json.loads(json.dumps(scn.to_config())))
        assert back == scn
        return ids, scn
    assert_equal(go)


def test_fleet_scenario_crosses_packages():
    """A scenario built by one package rebuilds in the other from its
    config, equal to the other's own build."""
    r = ref_cluster.FleetScenario.from_config(
        _hand_built(port_cluster, port_scen)[0].build().to_config())
    assert r == _hand_built(ref_cluster, ref_scen)[0].build()


@pytest.mark.parametrize("case", [
    "no_nodes", "no_streams", "unknown_node", "empty_pipeline",
    "child_first", "leave_before_join", "bad_slo", "bad_tier_mix",
    "bad_supernet", "bad_sid", "bad_phase", "spec_leftovers"])
def test_builder_validation_equal(case):
    def go(cl, co, sc):
        b = cl.FleetScenarioBuilder(case)
        if case == "no_nodes":
            return b.build()
        b.node("4K_2WS")
        if case == "no_streams":
            return b.build()
        if case == "unknown_node":
            return b.node_leave(99, at=1.0)
        if case == "empty_pipeline":
            return b.add_stream([])
        if case == "child_first":
            cfg = sc.registry.get("AR_Call").entries[1].to_config()
            cfg["model"]["name"] = "translate_gnmt"
            return b.add_stream([cfg])
        if case == "leave_before_join":
            nid = b.node("8K_2OS", at=1.0)
            b.node_leave(nid, at=0.5)
            b.fuzz_streams(cl.FuzzSpec(n_streams=2, seed=0))
            return b.build()
        if case == "bad_slo":
            return b.add_stream([{"model": {"builder": "kws_res8",
                                            "name": "kws", "kwargs": {}},
                                  "fps": 5.0}], slo=7)
        if case == "bad_tier_mix":
            return b.fuzz_streams(cl.FuzzSpec(
                n_streams=4, seed=0, slo=cl.SLOFuzz(tier_mix=(1.0, 2.0))))
        if case == "bad_supernet":
            return b.fuzz_streams(cl.FuzzSpec(
                n_streams=4, seed=0, slo=cl.SLOFuzz(supernet_frac=1.5)))
        if case == "bad_sid":
            return b.depart(5, at=0.1)
        if case == "bad_phase":
            b.fuzz_streams(cl.FuzzSpec(n_streams=2, seed=0))
            return b.phase({"kind": "nope"}, at=0.1)
        return b.fuzz_streams(cl.FuzzSpec(n_streams=2, seed=0),
                              fps_scale=2.0)
    got = assert_equal(go)
    assert got[0] == "raised"


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_split_pipelines_equal(scenario):
    got = assert_equal(lambda cl, co, sc: cl.split_pipelines(
        sc.registry.get(scenario)))
    assert got[0] == "ok"


def test_split_pipelines_of_a_fuzzed_scenario_equal():
    assert_equal(lambda cl, co, sc: cl.split_pipelines(
        sc.fuzz_scenario(17, cascade_prob=1.0, max_depth=3)))


# ---------------------------------------------------------------------------
# trace: the recorder, the bytes, loads across packages
# ---------------------------------------------------------------------------

def _recorded(cl):
    rec = cl.FleetTraceRecorder({"scenario": "t", "policy": "score",
                                 "seed": 3, "duration_s": 1.0})
    rec.node_join(0.0, 0, "4K_2WS")
    rec.node_join(0.1, 1, "8K_2OS")
    rec.stream(0.2, 0, [{"model": {"builder": "kws_res8", "name": "kws",
                                   "kwargs": {}}, "fps": 10.0}])
    rec.stream(0.25, 1, [{"model": {"builder": "kws_res8", "name": "k2",
                                    "kwargs": {}}, "fps": 5.0}],
               slo={"tier": 2})
    rec.place(0.2, 0, 1, 0)
    rec.place(0.25, 1, 0, 0, stage=1)
    rec.migrate(0.4, 0, 1, 0, 1)
    rec.migrate(0.45, 1, 0, 1, 1, stage=1, xfer_s=0.0082, xfer_j=3.1e-4)
    rec.phase(0.5, {"kind": "scale_fps", "factor": 2.5, "models": None},
              sids=[0, 1])
    rec.phase(0.55, {"kind": "scale_fps", "factor": 0.5, "models": None})
    rec.tune(0.6, [1.0, 0.62, 0.2, 0.15, 8.0], 41.2, True)
    rec.swap(0.65, 1, 2, pressure=0.97)
    rec.swap(0.66, 1, 0)
    rec.reject(0.7, 2, 2, pressure=1.12)
    rec.reject(0.71, 3, 1)
    rec.depart(0.8, 0, 3)
    rec.rejoin(0.9, 0)
    rec.node_drain(0.95, 1)
    rec.node_leave(0.99, 0)
    return rec.trace()


def test_recorder_dumps_bytes_equal_and_load_across(tmp_path):
    texts = [m.dumps(_recorded(m)) for m in (ref_cluster.trace,
                                             port_cluster.trace)]
    assert texts[0] == texts[1]
    assert ref_cluster.FLEET_EVENT_KINDS == port_cluster.FLEET_EVENT_KINDS
    assert ref_cluster.FLEET_TRACE_VERSION == port_cluster.FLEET_TRACE_VERSION
    for m in (ref_cluster, port_cluster):
        t = m.loads(texts[0])
        assert type(t) is m.FleetTrace
        assert m.dumps(t) == texts[0]
        assert [e["type"] for e in t.placements] == ["place", "place"]
        assert len(t.migrations) == 2 and len(t.events_of("swap")) == 2
        path = m.save_trace(t, str(tmp_path / f"{m.__name__}.jsonl"))
        assert m.dumps(m.load_trace(path)) == texts[0]
    assert (tmp_path / "repro.cluster.jsonl").read_bytes() == \
        (tmp_path / "repro_torch.cluster.jsonl").read_bytes()


def test_loads_rejects_foreign_formats_equal():
    sim_text = ref_scen.dumps(ref_scen.Trace(meta={"version": 1}, events=[]))
    fleet_text = ref_cluster.dumps(_recorded(ref_cluster))
    assert_equal(lambda cl, co, sc: cl.loads(sim_text))
    got = assert_equal(lambda cl, co, sc: sc.loads(fleet_text))
    assert got[0] == "raised"
    bad = fleet_text.replace('"version": 1', '"version": 99', 1)
    assert_equal(lambda cl, co, sc: cl.loads(bad))


# ---------------------------------------------------------------------------
# FleetNode: telemetry, stream_cost, place, evict, release, swap_level
# ---------------------------------------------------------------------------

def _node_state(node):
    return (node.telemetry(), node.offered_s, node.recent_dlv,
            node.probe_retriggers, node.placements, node.draining,
            node.alive, node.sim.t, node.sim.merged_frames,
            node.sim.merged_violated)


@pytest.mark.parametrize("system", ["4K_1WS2OS", "8K_2OS"])
def test_fleet_node_calls_equal(system):
    """One node of each package through the same placement churn: two
    whole pipelines of VR_Gaming (one with the OFA supernet, so
    ``swap_level`` has rungs), a weighted standalone stage, advances,
    a supernet swap, an eviction and a departure release."""
    def go(cl, co, sc):
        fl = __import__(f"{cl.__name__}.fleet", fromlist=["StreamView"])
        pipes = cl.split_pipelines(sc.registry.get("VR_Gaming"))
        views = [fl.StreamView(i, p) for i, p in enumerate(pipes)]
        node = cl.FleetNode(3, system, co.dream_full(seed=1),
                            duration_s=1.2, seed=5, window_s=0.3)
        log = [_node_state(node)]
        for sv in views:
            log.append(sv.cost_on(node))
            log.append(node.stream_cost(sv._graph_loads(), sv.head_period_s))
        specs, names = views[2].namespaced_specs(0)       # ctx_ofa
        node.place(2, specs, names, 0.0)
        specs, names = views[1].namespaced_specs(0)       # hand + pose
        node.place(1, specs, names, 0.05)
        spec, name = views[1].stage_spec(1, 1)
        node.place((1, 1), [spec], [name], 0.1, weights=[0.5])
        log.append(_node_state(node))
        for t in (0.2, 0.35):
            node.advance_to(t)
            log.append(_node_state(node))
        ofa = node.placements[2]
        before = node.offered_s
        node.swap_level(ofa, 1, 0.35)
        assert node.offered_s < before          # a lighter variant
        log.append(_node_state(node))
        node.advance_to(0.6)
        node.swap_level(ofa, 0, 0.6)
        node.evict((1, 1), 0.6)
        log.append(_node_state(node))
        node.advance_to(0.8)
        log.append(node.release(1, 0.8))
        log.append(_node_state(node))
        node.draining = True
        node.advance_to(1.2)
        log.append(_node_state(node))
        assert node.sim.merged_frames > 0
        log.append(result_fields(node.finalize()))
        return log
    got = assert_equal(go)
    assert got[0] == "ok"


def test_fleet_node_custom_system_and_routable():
    """A node over an explicit accelerator tuple is ``custom`` in both, and
    the port's node satisfies the router's ``RoutableNode`` surface."""
    def go(cl, co, sc):
        accs = co.SYSTEMS["4K_2WS"]
        node = cl.FleetNode(0, accs, co.dream_full(), duration_s=0.5,
                            seed=0)
        return node.system, node.telemetry()
    assert_equal(go)
    node = port_cluster.FleetNode(0, port_core.SYSTEMS["4K_2WS"],
                                  port_core.dream_full(), duration_s=0.5,
                                  seed=0)
    assert node.system == "custom"
    node = port_cluster.FleetNode(1, "4K_2WS", port_core.dream_full(),
                                  duration_s=0.5, seed=0)
    assert isinstance(node.node_id, int) and node.system == "4K_2WS"
    assert isinstance(node.telemetry(), port_cluster.NodeTelemetry)
