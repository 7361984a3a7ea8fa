"""The port's fleet-serving path against the JAX package's.

* the probes of ``repro_torch.core.adaptivity`` against ``repro.core.adaptivity``
  on the synthetic costs of ``tests/test_tuner.py``, from the same seeds;
* the routers of ``repro_torch.cluster.router`` shadowing the reference's,
  live, inside the reference's fleet simulator: at every decision the
  port's router of the same policy gets the same stream and node objects
  (duck-typed: it needs nothing more of them), and at every telemetry
  window the same window and an identical copy of the tuner's generator;
  and the same inside the port's fleet simulator, with the reference's
  router as the shadow, making the same decisions (node ids, scores and
  tuned weights) as the run inside the reference's;
* ``repro_torch.cluster.telemetry.FleetTelemetry`` fed the nodes and counters
  the reference fleet feeds its own, at every tune tick;
* ``repro_torch.launch.serve_fleet`` against ``examples/serve_fleet.py``:
  epoch windows, placements over engines with the same latency tables, and
  one run of the fleet server at smoke width on the CPU.

Every comparison is exact (bit for bit on floats, ``==`` on the rest): the
port's copies run the same numpy expressions in the same order.
"""
import copy
import dataclasses
import importlib.util
import json
import subprocess
import sys
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import repro.cluster.router as ref_router
import repro.core.adaptivity as ref_adapt
import repro_torch.cluster as port_cluster
import repro_torch.cluster.router as port_router
import repro_torch.core.adaptivity as port_adapt
from repro.cluster import FleetSimulator, TransferModel
from repro.cluster.telemetry import FleetTelemetry as RefFleetTelemetry
from repro.core.uxcost import WindowStats as RefWindowStats
from _torch_sim_parity import plain
from repro_torch.cluster.telemetry import FleetTelemetry as PortFleetTelemetry
from repro_torch.cluster.telemetry import TelemetryWindow as PortWindow
from repro_torch.core.uxcost import WindowStats as PortWindowStats

from test_cluster import cascade_fleet, small_fleet
from test_slo import SLO_CFG, tiered_fleet
from test_tuner import cascade_split_fleet, drift_fleet

ROOT = Path(__file__).resolve().parents[1]


def bits(x) -> bytes:
    """The bytes of a float or float array: equal bits, not just ==."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).tobytes()


# ---------------------------------------------------------------------------
# probes: the synthetic costs of tests/test_tuner.py
# ---------------------------------------------------------------------------

def _coord_state(p) -> tuple:
    return (bits(p.center), p.radius, p.probing, p.pass_pos, p.fresh_pass,
            [bits(c) for c in p.candidates],
            [(c, bits(x)) for c, x in p.results], p.cand_idx, p.commits,
            p.steps, p.retriggers, p.axis, p.axis_order)


def _star_state(p) -> tuple:
    return (bits(p.center), p.radius, p.probing,
            [bits(c) for c in p.candidates],
            [(c, bits(x)) for c, x in p.results], p.cand_idx)


@pytest.mark.parametrize("margin", [0.02, 0.0, 0.5])
def test_coordinate_probe_step_batch_equal(margin):
    """test_coordinate_probe_converges_on_synthetic_cost's drive, and its
    margin-gated variants: the same centers and commits at every window."""
    target = np.array([0.4, 1.6, 1.0])
    kw = dict(center=np.ones(3), lo=np.zeros(3), hi=np.full(3, 2.0),
              radius=0.5, r_min=0.05, shrink=0.6, margin=margin)
    probes = [m.CoordinateProbe(**kw) for m in (ref_adapt, port_adapt)]
    rngs = [np.random.default_rng(0) for _ in probes]
    cost = lambda p: float(np.sum((p - target) ** 2))
    for _ in range(200):
        outs = [p.step_batch(cost, r) for p, r in zip(probes, rngs)]
        assert bits(outs[0]) == bits(outs[1])
        assert _coord_state(probes[0]) == _coord_state(probes[1])
        if not probes[0].probing:
            break
    assert not probes[1].probing and probes[1].steps > 3
    if margin == 0.02:
        assert probes[1].commits > 0


def test_coordinate_probe_sequential_step_equal():
    """The sequential drive of tests/test_tuner.py: one candidate per
    window."""
    target = np.array([0.5, 1.5])
    probes = [m.CoordinateProbe(center=np.ones(2), lo=np.zeros(2),
                                hi=np.full(2, 2.0), radius=0.5, margin=0.0)
              for m in (ref_adapt, port_adapt)]
    rngs = [np.random.default_rng(1) for _ in probes]
    live = [p.current() for p in probes]
    for _ in range(300):
        if not probes[0].probing:
            break
        live = [p.step(float(np.sum((x - target) ** 2)), r)
                for p, x, r in zip(probes, live, rngs)]
        assert bits(live[0]) == bits(live[1])
        assert _coord_state(probes[0]) == _coord_state(probes[1])
    assert not probes[1].probing and probes[1].commits > 0


def test_coordinate_probe_retrigger_and_margin_equal():
    """test_coordinate_probe_retrigger_restarts_pass and
    test_coordinate_probe_margin_blocks_marginal_commits, on both."""
    states = []
    for m in (ref_adapt, port_adapt):
        p = m.CoordinateProbe(center=np.ones(2), lo=np.zeros(2),
                              hi=np.full(2, 2.0), radius=0.5, r_min=0.4,
                              axis_order=(1, 0))
        rng = np.random.default_rng(0)
        p.step_batch(lambda x: float(x[1]), rng)
        s1 = _coord_state(p)
        p.probing = False
        p.retrigger()
        s2 = _coord_state(p)
        p.step_batch(lambda x: float(np.sum(x)), rng)   # the distant draw
        s3 = _coord_state(p)
        q = m.CoordinateProbe(center=np.ones(1), lo=np.zeros(1),
                              hi=np.full(1, 2.0), radius=0.5, margin=0.5)
        q.step_batch(lambda x: 1.0 - 0.1 * abs(float(x[0]) - 1.0),
                     np.random.default_rng(0))
        states.append((s1, s2, s3, _coord_state(q)))
    assert states[0] == states[1]
    assert states[1][3][8] == 0                    # the margin held


def test_probe_search_star_equal():
    """test_probe_search_star_shape_matches_legacy_2d, driven through whole
    star cycles with retriggers."""
    target = np.array([0.3, 1.7])
    probes = [m.ProbeSearch(center=np.array([1.0, 1.0]), radius=0.5)
              for m in (ref_adapt, port_adapt)]
    rngs = [np.random.default_rng(0) for _ in probes]
    cost = 0.0
    for i in range(120):
        if i == 40:
            for p in probes:
                p.retrigger(0.6)
        outs = [p.step(cost, r) for p, r in zip(probes, rngs)]
        assert bits(outs[0]) == bits(outs[1])
        assert _star_state(probes[0]) == _star_state(probes[1])
        cost = float(np.sum((outs[0] - target) ** 2))
    assert np.asarray(probes[1].candidates).shape in ((6, 2), (0,))


@pytest.mark.parametrize("init,seed", [(None, 0), ((1.0, 1.0), 3),
                                       ((0.1, 1.9), 7)])
def test_optimize_params_and_grid_search_equal(init, seed):
    f = lambda a, b: (a - 0.7) ** 2 + 2.0 * (b - 1.3) ** 2 + 0.1 * a * b
    traces = [m.optimize_params(f, init=init, seed=seed)
              for m in (ref_adapt, port_adapt)]
    assert traces[0].points == traces[1].points
    assert bits(traces[0].costs) == bits(traces[1].costs)
    assert traces[0].evals == traces[1].evals > 10
    assert traces[0].best == traces[1].best
    grids = [m.grid_search(f, n=7) for m in (ref_adapt, port_adapt)]
    assert grids[0][:2] == grids[1][:2]
    assert bits(grids[0][2]) == bits(grids[1][2])


# ---------------------------------------------------------------------------
# routers, live: the port's router shadows the reference's inside the fleet
# ---------------------------------------------------------------------------

def _probe_view(pol) -> tuple:
    return (pol.weights, pol.windows_seen, pol.empty_windows,
            pol.held_windows, _coord_state(pol.probe))


ROUTERS = {"ref": (ref_router, port_router), "port": (port_router, ref_router)}


def shadowed(policy: str, vectorized: bool, budget_aware: bool = False,
             host: str = "ref", **kw):
    """A router of ``policy`` from package ``host`` whose every decision is
    also made by the other package's router of the same policy, and
    compared. The shadow is ``.other``; ``.log`` keeps the decisions: node
    ids, score bits and tuned weights."""
    host_router, other_router = ROUTERS[host]
    host_cls = host_router.POLICIES[policy]

    class Shadow(host_cls):
        def __init__(self):
            super().__init__(**kw)
            self.other = other_router.POLICIES[policy](**kw)
            self.log = []
            for pol in (self, self.other):
                if isinstance(pol, (ref_router.ScoreDrivenRouter,
                                    port_router.ScoreDrivenRouter)):
                    pol.vectorized = vectorized
                    pol.budget_aware = budget_aware
            self.checked = dict.fromkeys(
                ("place", "place_stages", "score_all", "score",
                 "stage_score", "transfer_penalty", "on_window", "rearm"),
                0)
            self._in_stages = False

        def _scores_agree(self, stream, nodes):
            if isinstance(self, host_router.ScoreDrivenRouter):
                a = host_cls.score_all(self, stream, nodes)
                b = self.other.score_all(stream, nodes)
                assert bits(a) == bits(b)
                self.log.append(("scores", bits(a)))
                self.checked["score_all"] += 1

        def place(self, stream, nodes):
            got = super().place(stream, nodes)
            if not self._in_stages:
                self._scores_agree(stream, nodes)
                assert self.other.place(stream, nodes) == got
                self.log.append(("place", stream.sid, got))
                self.checked["place"] += 1
            return got

        def place_stages(self, stream, nodes, transfer):
            self._in_stages = True
            try:
                got = super().place_stages(stream, nodes, transfer)
            finally:
                self._in_stages = False
            self._scores_agree(stream, nodes)
            assert self.other.place_stages(stream, nodes, transfer) == got
            self.log.append(("place_stages", stream.sid, got))
            self.checked["place_stages"] += 1
            return got

        def score_all(self, stream, nodes):
            got = super().score_all(stream, nodes)
            assert bits(self.other.score_all(stream, nodes)) == bits(got)
            self.checked["score_all"] += 1
            return got

        def score(self, stream, node, best_iso):
            got = super().score(stream, node, best_iso)
            assert bits(self.other.score(stream, node, best_iso)) == bits(got)
            self.log.append(("score", node.node_id, bits(got)))
            self.checked["score"] += 1
            return got

        def stage_score(self, stream, k, node, best_iso, parent_nid,
                        transfer):
            got = super().stage_score(stream, k, node, best_iso,
                                      parent_nid, transfer)
            assert bits(self.other.stage_score(
                stream, k, node, best_iso, parent_nid, transfer)) == bits(got)
            self.log.append(("stage_score", k, node.node_id, bits(got)))
            self.checked["stage_score"] += 1
            return got

        def transfer_penalty(self, stream, k, transfer):
            got = super().transfer_penalty(stream, k, transfer)
            assert bits(self.other.transfer_penalty(stream, k, transfer)) \
                == bits(got)
            self.checked["transfer_penalty"] += 1
            return got

    if not hasattr(host_cls, "on_window"):
        return Shadow()

    class TunedShadow(Shadow):
        def on_window(self, window, rng):
            mine = copy.deepcopy(rng)
            got = super().on_window(window, rng)
            assert self.other.on_window(window, mine) == got
            assert mine.bit_generator.state == rng.bit_generator.state
            assert _probe_view(self.other) == _probe_view(self)
            assert bits(self.other.multipliers) == bits(self.multipliers)
            self.log.append(("on_window", got, self.weights))
            self.checked["on_window"] += 1
            return got

        def rearm(self):
            super().rearm()
            self.other.rearm()
            self.checked["rearm"] += 1

    return TunedShadow()


WINDOW_FIELDS = [f.name for f in dataclasses.fields(PortWindow)]


def assert_windows_equal(ref_win, port_win):
    assert type(port_win) is PortWindow
    for name in WINDOW_FIELDS + ["norm_uxcost", "mean_pipeline_latency_s",
                                 "empty"]:
        a, b = getattr(ref_win, name), getattr(port_win, name)
        assert type(a) is type(b), name
        if isinstance(a, float):
            assert bits(a) == bits(b), name
        elif isinstance(a, dict):
            assert list(a) == list(b), name
            assert [bits(v) if isinstance(v, float) else v
                    for v in a.values()] == \
                [bits(v) if isinstance(v, float) else v
                 for v in b.values()], name
        else:
            assert a == b, name


class ShadowTelemetry(RefFleetTelemetry):
    """The reference's aggregator, with the port's fed the same arguments
    at every observe and its window held equal field by field."""

    def __init__(self, canonical):
        super().__init__(canonical=canonical)
        self.port = PortFleetTelemetry(canonical=canonical)
        self.compared = 0

    def observe(self, t, nodes, migrations, xfer_energy_j, departures=0,
                rejections=0, swaps=0):
        got = super().observe(t, nodes, migrations, xfer_energy_j,
                              departures, rejections, swaps)
        assert_windows_equal(got, self.port.observe(
            t, nodes, migrations, xfer_energy_j, departures, rejections,
            swaps))
        self.compared += 1
        return got


class PortShadowTelemetry(PortFleetTelemetry):
    """The port's aggregator inside the port's fleet simulator, with the
    reference's fed the same arguments and held equal field by field."""

    def __init__(self, canonical):
        super().__init__(canonical=canonical)
        self.ref = RefFleetTelemetry(canonical=canonical)
        self.compared = 0

    def observe(self, t, nodes, migrations, xfer_energy_j, departures=0,
                rejections=0, swaps=0):
        got = super().observe(t, nodes, migrations, xfer_energy_j,
                              departures, rejections, swaps)
        assert_windows_equal(self.ref.observe(
            t, nodes, migrations, xfer_energy_j, departures, rejections,
            swaps), got)
        self.compared += 1
        return got


#: small scenarios of tests/test_cluster.py and tests/test_tuner.py, with
#: tune and rebalance ticks so that every router entry point is reached
SCENARIOS = {
    "small_churn": (lambda: small_fleet(churn=True),
                    dict(duration_s=1.5, seed=2, tune_every_s=0.25,
                         rebalance_every_s=0.5)),
    "drift_churn_phase": (lambda: drift_fleet(churn=True, phase=True),
                          dict(duration_s=1.5, seed=2, tune_every_s=0.25,
                               rebalance_every_s=0.5)),
    "drift_commits": (lambda: drift_fleet(seed=1, phase=True),
                      dict(duration_s=1.5, seed=1, tune_every_s=0.2,
                           rebalance_every_s=0.4)),
    "cascade_split_churn": (lambda: cascade_fleet(churn=True),
                            dict(duration_s=1.5, seed=3,
                                 transfer=TransferModel(), split_stages=True,
                                 tune_every_s=0.25, rebalance_every_s=0.5)),
    "cascade_split_link": (lambda: cascade_split_fleet(),
                           dict(duration_s=0.8, seed=3, split_stages=True,
                                transfer=TransferModel(
                                    link_bandwidth_bytes_s=1.25e9),
                                tune_every_s=0.2, rebalance_every_s=0.4)),
    "slo_tiers": (lambda: tiered_fleet(),
                  dict(duration_s=1.0, seed=3, slo=SLO_CFG, slo_every_s=0.1,
                       tune_every_s=0.2, rebalance_every_s=0.5)),
}
POLICY_NAMES = ("round_robin", "least_loaded", "score", "score_whole",
                "tuned_score")


def run_shadowed(scenario: str, policy: str, vectorized: bool,
                 host: str = "ref", **kw):
    """One shadowed run in package ``host``'s fleet simulator. The port's
    run takes the reference's scenario through its config, and its
    transfer model likewise."""
    make, fkw = SCENARIOS[scenario]
    pol = shadowed(policy, vectorized, host=host, **kw)
    scn, fkw = make(), dict(fkw)
    sim, tel = FleetSimulator, ShadowTelemetry
    if host == "port":
        sim, tel = port_cluster.FleetSimulator, PortShadowTelemetry
        scn = port_cluster.FleetScenario.from_config(scn.to_config())
        if "transfer" in fkw:
            fkw["transfer"] = port_cluster.TransferModel.from_config(
                fkw["transfer"].to_config())
    fs = sim(scn, pol, **fkw)
    fs.telemetry = tel(fs.telemetry.canonical)
    if fs._slo_tel is not None:
        fs._slo_tel = tel(fs._slo_tel.canonical)
    result = fs.run()
    return fs, pol, result


@pytest.mark.parametrize("vectorized", [True, False],
                         ids=["vectorized", "scalar"])
@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_and_telemetry_shadow_the_reference_live(scenario, policy,
                                                        vectorized):
    fs, pol, _ = run_shadowed(scenario, policy, vectorized)
    c = pol.checked
    assert c["place"] + c["place_stages"] > 0
    if fs.split:
        assert c["place_stages"] > 0
    if policy in ("score", "tuned_score") and not vectorized:
        assert c["score"] > 0 or c["stage_score"] > 0
    if policy == "tuned_score":
        assert c["on_window"] == pol.windows_seen > 0
        assert c["rearm"] == pol.probe.retriggers > 0
        assert _probe_view(pol.other) == _probe_view(pol)
    assert fs.telemetry.compared == len(fs.telemetry.windows) > 0
    if fs._slo_tel is not None:
        assert fs._slo_tel.compared > 0


def _fleet_view(fs, r) -> dict:
    return {"frames": r.frames, "uxcost": plain(r.uxcost),
            "migrations": r.migrations, "weights": plain(r.weights),
            "stream_node": dict(fs.stream_node),
            "stage_node": dict(fs.stage_node)}


@pytest.mark.parametrize("vectorized", [True, False],
                         ids=["vectorized", "scalar"])
@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_and_telemetry_shadow_in_the_port_simulator(
        scenario, policy, vectorized):
    """The shadowed runs inside the port's own fleet simulator, the
    reference's router shadowing the port's: at every decision the same
    node ids, scores and tuned weights as the run inside the reference's
    simulator, and the same result."""
    fs, pol, r = run_shadowed(scenario, policy, vectorized, host="port")
    rfs, rpol, rr = run_shadowed(scenario, policy, vectorized)
    assert isinstance(pol, port_router.RouterPolicy)
    assert isinstance(fs.nodes[0], port_cluster.FleetNode)
    c = pol.checked
    assert c["place"] + c["place_stages"] > 0
    if fs.split:
        assert c["place_stages"] > 0
    if policy in ("score", "tuned_score") and not vectorized:
        assert c["score"] > 0 or c["stage_score"] > 0
    if policy == "tuned_score":
        assert c["on_window"] == pol.windows_seen > 0
        assert _probe_view(pol.other) == _probe_view(pol)
    assert fs.telemetry.compared == len(fs.telemetry.windows) > 0
    assert pol.log == rpol.log and len(pol.log) > 0
    assert c == rpol.checked
    assert _fleet_view(fs, r) == _fleet_view(rfs, rr)


def test_shadowed_tuner_commits_and_the_port_follows():
    """On the degrading fleet the reference's tuner commits away from the
    static weights; the port's commits at the same windows to the same
    weights (a run with no commit would test less)."""
    _, pol, r = run_shadowed("drift_commits", "tuned_score", True)
    assert r.tuner_commits > 0 and pol.other.probe.commits == r.tuner_commits
    assert pol.other.weights == tuple(r.weights) != \
        tuple(port_router.STATIC_WEIGHTS)


@pytest.mark.parametrize("margin", [0.0, 0.1])
def test_shadowed_tuner_margins_and_budget_aware(margin):
    fs, pol, _ = run_shadowed("slo_tiers", "tuned_score", True,
                              budget_aware=True, margin=margin)
    assert pol.other.budget_aware and pol.checked["on_window"] > 0
    bfs = {sv.budget_factor for sv in fs.streams.values()}
    assert len(bfs) > 1                # the budgets really differ
    assert _probe_view(pol.other) == _probe_view(pol)


def test_tuner_metrics_hook_publishes_equal_samples():
    """With observability on, the fleet attaches its registry to the
    reference's tuner; the port's, given a port registry, publishes the same
    router samples."""
    from repro_torch.obs import MetricsRegistry
    pol = shadowed("tuned_score", True, margin=0.0)
    pol.other.metrics = MetricsRegistry()
    make, fkw = SCENARIOS["drift_commits"]
    fs = FleetSimulator(make(), pol, **fkw, obs=True)
    fs.run()
    assert pol.metrics is fs.obs.metrics
    ref_snap = {k: v for k, v in fs.obs.metrics.snapshot().items()
                if k.startswith("router_")}
    assert set(ref_snap) == {"router_weight", "router_tune_commits_total"}
    assert pol.other.metrics.snapshot() == ref_snap


def test_hindsight_cost_equal_past_the_overload_knee():
    """The tuner's counterfactual cost on recorded decisions whose loads run
    past ``OVERLOAD_KNEE``, under random multipliers in the probe's box."""
    rng = np.random.default_rng(9)
    decisions = []
    for _ in range(12):
        n = int(rng.integers(2, 5))
        ids = sorted(int(i) for i in rng.choice(8, n, replace=False))
        terms = rng.random((n, 5)) * np.array([1.6, 0.5, 2.0, 1.0, 0.3])
        decisions.append((ids, terms, rng.random(n) * 0.4))
    node_dlv = {i: float(rng.random()) for i in range(8)}
    costs = [m.TunedScoreRouter()._hindsight_cost(decisions, node_dlv)
             for m in (ref_router, port_router)]
    lax = port_router.TunedScoreRouter()
    lax.OVERLOAD_KNEE = 10.0
    no_knee = lax._hindsight_cost(decisions, node_dlv)
    knee_bites = 0
    for _ in range(50):
        mult = rng.uniform(port_router.TUNE_LO, port_router.TUNE_HI)
        assert bits(costs[0](mult)) == bits(costs[1](mult))
        knee_bites += costs[1](mult) != no_knee(mult)
    assert knee_bites > 0


def test_make_policy_and_constants_equal():
    for name in ("STATIC_WEIGHTS", "WEIGHT_NAMES", "TUNE_LO", "TUNE_HI",
                 "TUNE_AXIS_ORDER", "W_BACKLOG", "W_PREF", "W_UX",
                 "URGENCY_CAP", "W_XFER"):
        assert getattr(port_router, name) == getattr(ref_router, name)
    assert sorted(port_router.POLICIES) == sorted(ref_router.POLICIES)
    for name in port_router.POLICIES:
        pol = port_router.make_policy(name)
        assert pol.name == name
        assert port_router.make_policy(pol) is pol
    with pytest.raises(ValueError, match="unknown router policy"):
        port_router.make_policy("fastest")
    pol = port_router.TunedScoreRouter()
    with pytest.raises(ValueError):
        pol.set_weights([1.0, 2.0])
    with pytest.raises(ValueError):
        pol.set_weights([1.0, -0.1, 0.2, 0.15, 8.0])


# ---------------------------------------------------------------------------
# telemetry windows (tests/test_tuner.py and tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_telemetry_deltas_and_empty_windows_equal():
    fs = FleetSimulator(drift_fleet(phase=False), "score", duration_s=1.0,
                        seed=2)
    fs.run()
    tels = [RefFleetTelemetry(), PortFleetTelemetry()]
    for t, mig, xj, dep, rej, sw in ((0.5, 1, 0.5, 2, 3, 4),
                                     (1.0, 4, 0.75, 2, 8, 9),
                                     (1.0, 4, 0.75, 2, 8, 9)):
        wins = [tel.observe(t, fs.nodes, mig, xj, departures=dep,
                            rejections=rej, swaps=sw) for tel in tels]
        assert_windows_equal(*wins)
    assert not tels[1].windows[0].empty and tels[1].windows[2].empty
    assert tels[1].windows[1].rejections == 5
    for args in (({}, 0, 0.0), ({}, 2, 1.5)):
        assert_windows_equal(RefFleetTelemetry().observe(0.1, *args),
                             PortFleetTelemetry().observe(0.1, *args))


def test_held_windows_equal():
    """test_zero_length_window_is_empty_and_holds_static_weights and
    test_signal_free_window_holds_weights, on both routers."""
    out = []
    for mod in (ref_router, port_router):
        pol = mod.TunedScoreRouter()
        pol._decisions.append(([0, 1], np.zeros((2, 5)), np.zeros(2)))
        rng = np.random.default_rng(0)
        empty = PortWindow(
            t0=0.5, t1=0.5, frames=0, violated=0, dlv_rate=0.0, uxcost=0.0,
            node_dlv={}, node_frames={}, backlog_p50=0.0, backlog_p90=0.0,
            backlog_max=0.0, migrations=0, xfer_j=0.0, stream_uxcost={})
        quiet = dataclasses.replace(empty, t1=1.0, frames=10, uxcost=0.1,
                                    node_dlv={0: 0.0, 1: 0.0},
                                    node_frames={0: 5, 1: 5}, n_models=2)
        out.append((pol.on_window(empty, rng), pol.on_window(quiet, rng),
                    _probe_view(pol), len(pol._decisions)))
    assert out[0] == out[1]
    assert out[1][:2] == (None, None) and out[1][2][2:4] == (1, 1)


# ---------------------------------------------------------------------------
# the fleet server against examples/serve_fleet.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "serve_fleet_example", ROOT / "examples" / "serve_fleet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_epoch_window_equal_over_three_epochs(example):
    from repro_torch.launch import serve_fleet as port_fleet
    rng = np.random.default_rng(5)
    nodes = [types.SimpleNamespace(node_id=i, engine=types.SimpleNamespace(
        stats=PortWindowStats())) for i in range(3)]
    prev_ref, prev_port = {}, {}
    for epoch in range(3):
        for node in nodes[:2 if epoch == 0 else 3]:
            for name in ("detector", "kws", "context")[:1 + epoch]:
                st = node.engine.stats.model(name)
                f = int(rng.integers(0, 9))
                st.frames += f
                st.violated += int(rng.integers(0, f + 1))
                st.energy_j += float(rng.random())
                st.worst_energy_j += float(rng.random()) + 1.0
        wins = (example.epoch_window(epoch, nodes, prev_ref),
                port_fleet.epoch_window(epoch, nodes, prev_port))
        assert_windows_equal(*wins)
        assert prev_ref == prev_port
        assert wins[1].frames == sum(wins[1].node_frames.values())
    assert wins[1].n_models > 0 and wins[1].uxcost > 0.0


#: hand-set isolated latencies (s) on a speed-1.0 slice
LAT_TABLES = [
    {"detector": 0.010, "verifier": 0.018, "context": 0.030, "kws": 0.006},
    {"detector": 0.004, "verifier": 0.050, "context": 0.012, "kws": 0.021},
]


def _engines(serving_mod, lat):
    out = []
    for name, slices in (("big", (("big0", 1.0, 1.0), ("big1", 1.0, 1.0))),
                         ("small", (("small0", 0.45, 0.4),
                                    ("small1", 0.45, 0.4)))):
        e = serving_mod.ServingEngine([
            serving_mod.VirtualAccelerator(a, speed=s, power=p)
            for a, s, p in slices])
        for model, base in lat.items():
            for acc in e.accs:
                e.lat_table[(model, acc.name)] = base / acc.speed
        out.append((name, e))
    return out


@pytest.mark.parametrize("lat", range(len(LAT_TABLES)))
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_engine_placements_equal_to_the_example(example, policy, lat):
    """The example's six streams over two engines with the same latency
    table: the reference's router on the example's adapters (given the
    ``system`` attribute that the reference's batched scoring reads and the
    example's adapter lacks), the port's router on the example's adapters as
    they are, and the port's router on the port's adapters place every
    stream on the same node, for two epochs with a feedback window."""
    import repro.serving as ref_serving
    import repro_torch.serving as port_serving
    from repro_torch.launch import serve_fleet as port_fleet

    class RefEngineNode(example.EngineNode):
        system = "custom"

    table = LAT_TABLES[lat]
    fleets = [
        (ref_router.make_policy(policy),
         [RefEngineNode(i, n, e)
          for i, (n, e) in enumerate(_engines(ref_serving, table))],
         [example.EngineStream(m, f) for m, f in port_fleet.STREAMS]),
        (port_router.make_policy(policy),
         [example.EngineNode(i, n, e)
          for i, (n, e) in enumerate(_engines(ref_serving, table))],
         [example.EngineStream(m, f) for m, f in port_fleet.STREAMS]),
        (port_router.make_policy(policy),
         [port_fleet.EngineNode(i, n, e)
          for i, (n, e) in enumerate(_engines(port_serving, table))],
         port_fleet.make_streams()),
    ]
    win = PortWindow(
        t0=0.0, t1=1.0, frames=20, violated=6, dlv_rate=0.3, uxcost=0.5,
        node_dlv={0: 0.5, 1: 0.1}, node_frames={0: 10, 1: 10},
        backlog_p50=0.0, backlog_p90=0.0, backlog_max=0.0, migrations=0,
        xfer_j=0.0, stream_uxcost={}, n_models=4)
    seen = []
    for pol, nodes, streams in fleets:
        placed = []
        for _ in range(2):
            placed.append(port_fleet.place_streams(pol, nodes, streams))
            placed.append([n.offered_s for n in nodes])
            if hasattr(pol, "on_window"):
                pol.on_window(win, np.random.default_rng(0))
                placed.append((pol.weights, pol.probe.commits))
        seen.append(placed)
    assert seen[0] == seen[1] == seen[2]
    assert len(set(seen[2][0])) == 2 or policy != "round_robin"


def test_example_adapter_without_system_breaks_the_reference_router(example):
    """Why the test above gives the reference's router a ``system``: the
    example's adapter has none, and the reference's batched scoring reads
    it. The port's router needs only ``node_id`` and ``telemetry()``."""
    import repro.serving as ref_serving
    nodes = [example.EngineNode(i, n, e)
             for i, (n, e) in enumerate(_engines(ref_serving,
                                                 LAT_TABLES[0]))]
    stream = example.EngineStream("detector", 8)
    with pytest.raises(AttributeError, match="system"):
        ref_router.make_policy("score").place(stream, nodes)
    assert port_router.make_policy("score").place(stream, nodes) in (0, 1)


def test_serve_fleet_cli_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.serve_fleet`` at smoke width on the
    CPU: both nodes serve frames, and the obs export holds valid spans, the
    engines' job spans of each frame among them, and Prometheus text whose
    ``serve_frames_total`` sums to the fleet's frames."""
    from repro.obs import validate_span as ref_validate_span
    from repro_torch.obs import load_jsonl, parse_prometheus, validate_span
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_fleet",
         "--device", "cpu", "--policy", "tuned_score", "--epochs", "2",
         "--duration", "1", "--obs", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    summary = [ln for ln in lines if "fleet UXCost" in ln]
    assert len(summary) == 1
    frames = int(summary[0].split(" over ")[1].split()[0])
    assert frames > 0
    for node in ("big", "small"):
        served = [ln for ln in lines if f"node {node}: frames=" in ln]
        assert served and int(served[-1].split("frames=")[1].split()[0]) > 0
    assert sum("DLV=" in ln for ln in lines) == 2      # one window an epoch
    spans = load_jsonl(str(tmp_path / "spans.jsonl"))
    for rec in spans:
        validate_span(rec)
        ref_validate_span(rec)
    assert [r["kind"] for r in spans].count("place") == 12
    assert [r["kind"] for r in spans].count("epoch") == 2
    # each node's engine records its frames' jobs, tagged with the node; a
    # dropped or abandoned frame counts among the fleet's frames too
    jobs = Counter(r["attrs"]["outcome"] for r in spans if r["kind"] == "job")
    assert jobs["done"] > 0
    assert jobs["done"] + jobs["dropped"] + jobs["aborted"] == frames
    runs = [r for r in spans if r["kind"] == "engine.run"]
    assert {r["attrs"]["node"] for r in runs} == {"big", "small"}
    node_of = {r["sid"]: r["attrs"]["node"] for r in runs}
    assert all(node_of[r["attrs"]["run"]] == r["attrs"]["node"]
               for r in spans if r["kind"].startswith(("job", "engine."))
               and r["kind"] != "engine.run")
    samples = parse_prometheus((tmp_path / "metrics.prom").read_text())
    served = sum(s["value"] for s in samples
                 if s["name"] == "serve_frames_total")
    assert served == frames
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert "serve_fleet_uxcost" in snap


def test_serve_fleet_in_process_feeds_windows_and_frees_queues():
    """The same run in process: windows add up to the fleet's frames, the
    tuner saw every epoch, its weights stay in bounds, and what is kept of
    the queues is one served request per (node, model)."""
    from repro_torch.launch import serve_fleet as port_fleet
    run = port_fleet.main(["--device", "cpu", "--policy", "tuned_score",
                           "--epochs", "2", "--duration", "0.6"])
    assert sum(w.frames for w in run.windows) == run.frames > 0
    assert run.policy.windows_seen == 2
    mult = run.policy.multipliers
    assert np.all(mult >= np.asarray(port_router.TUNE_LO))
    assert np.all(mult <= port_router.TUNE_HI)
    assert all(n.cuda_stream is None and n.served_on is None
               for n in run.nodes)
    assert set(run.last_served) == set().union(*map(set, run.served))
    for (nid, model), req in run.last_served.items():
        assert req.model == model and req.result is not None
        assert tuple(req.result.shape) == (1, 32, 128)
    assert len(run.epoch_wall_s) == len(run.busy_s) == 2
