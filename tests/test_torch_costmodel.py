"""The port's model zoo, cost model, MapScore and engine presets against the
JAX package's (``repro_torch.core`` against ``repro.core``), exactly.

Both packages run the same numpy operations in the same order, so every
array and float is compared bit for bit (``tests/_torch_sim_parity.py``'s
``plain``); the cost-table memos are cleared on both sides first, so no
result depends on what a cache held.
"""
import importlib
import math

import numpy as np
import pytest

import repro.core.costmodel as ref_cm
import repro.core.engine as ref_engine
import repro.core.types as ref_types
import repro.core.zoo as ref_zoo
import repro_torch.core.costmodel as port_cm
import repro_torch.core.engine as port_engine
import repro_torch.core.types as port_types
import repro_torch.core.zoo as port_zoo
from _torch_sim_parity import PACKAGES, SCENARIOS, plain

# ``repro.core.mapscore`` is also the name of the function the package
# exports, which ``import ... as`` would bind
ref_ms = importlib.import_module("repro.core.mapscore")
port_ms = importlib.import_module("repro_torch.core.mapscore")

ZOO = sorted(ref_zoo.ZOO_BUILDERS)
SYSTEMS = sorted(ref_types.SYSTEMS)


@pytest.fixture(autouse=True)
def _cold_caches():
    ref_cm.clear_table_cache()
    port_cm.clear_table_cache()
    yield
    ref_cm.clear_table_cache()
    port_cm.clear_table_cache()


def test_zoo_and_systems_are_the_same_sets():
    assert sorted(port_zoo.ZOO_BUILDERS) == ZOO
    assert sorted(port_types.SYSTEMS) == SYSTEMS
    assert port_types.HETERO_SYSTEMS == ref_types.HETERO_SYSTEMS
    assert port_types.HOMO_SYSTEMS == ref_types.HOMO_SYSTEMS
    assert plain(port_types.SYSTEMS) == plain(ref_types.SYSTEMS)


@pytest.mark.parametrize("builder", ZOO)
def test_zoo_graph_equal(builder):
    """Every layer, dynamicity hook, variant and generative spec."""
    ref_g = ref_zoo.ZOO_BUILDERS[builder]()
    port_g = port_zoo.ZOO_BUILDERS[builder]()
    assert plain(port_g) == plain(ref_g)
    assert port_g.macs == ref_g.macs
    assert port_g.weight_bytes == ref_g.weight_bytes
    assert port_g.worst_path() == ref_g.worst_path()
    rr, pr = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        assert port_g.sample_path(pr) == ref_g.sample_path(rr)


@pytest.mark.parametrize("builder", ZOO)
def test_build_cached_relabels_alike(builder):
    ref_g = ref_zoo.build_cached(builder, name="s3.x")
    port_g = port_zoo.build_cached(builder, name="s3.x")
    assert plain(port_g) == plain(ref_g)
    assert port_zoo.build_cached(builder, name="s3.x") is port_g


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("builder", ZOO)
def test_cost_table_equal(builder, system):
    """Each ``CostTable`` array, and the isolated latencies, of the model
    and of each of its variants on the system."""
    ref_g = ref_zoo.ZOO_BUILDERS[builder]()
    port_g = port_zoo.ZOO_BUILDERS[builder]()
    for rg, pg in zip((ref_g, *ref_g.variants), (port_g, *port_g.variants)):
        for shared in (True, False):
            rt = ref_cm.build_cost_table(rg, ref_types.SYSTEMS[system], shared)
            pt = port_cm.build_cost_table(pg, port_types.SYSTEMS[system],
                                          shared)
            assert plain(pt) == plain(rt)
            for name in ("lat", "en", "in_bytes", "out_bytes", "lat_mean",
                         "lat_sum", "lat_min", "en_sum", "en_max"):
                assert np.array_equal(getattr(pt, name), getattr(rt, name))
    for layer_r, layer_p in zip(ref_g.layers, port_g.layers):
        acc_r, acc_p = ref_types.SYSTEMS[system][0], port_types.SYSTEMS[system][0]
        assert (port_cm.layer_latency_s(layer_p, acc_p)
                == ref_cm.layer_latency_s(layer_r, acc_r))
        assert (port_cm.layer_energy_j(layer_p, acc_p)
                == ref_cm.layer_energy_j(layer_r, acc_r))
    assert port_cm.model_state_bytes(port_g) == ref_cm.model_state_bytes(ref_g)
    assert port_cm.activation_bytes(port_g) == ref_cm.activation_bytes(ref_g)


def test_table_memo_counts_alike():
    """The memo's hit and miss counts move alike, and a relabelled graph
    shares its arrays with the original in both packages."""
    for cm, zoo, types in ((ref_cm, ref_zoo, ref_types),
                           (port_cm, port_zoo, port_types)):
        accs = types.SYSTEMS["4K_1WS2OS"]
        a = cm.build_cost_table(zoo.build_cached("kws_res8"), accs)
        b = cm.build_cost_table(zoo.build_cached("kws_res8", name="n1"), accs)
        assert b.lat is a.lat and b.model_name == "n1"
    assert port_cm.table_cache_info() == ref_cm.table_cache_info()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_build_tables_and_deadlines_equal(scenario):
    """``build_tables`` over a scenario's models and their variants, and
    ``effective_deadline`` with and without an explicit deadline and the
    generative graph, on two systems."""
    out = {}
    for pkg, (core, _) in PACKAGES.items():
        scn = core.build_scenario(scenario, 0.5)
        rows = []
        for system in ("4K_1WS2OS", "8K_2OS"):
            models = {s.model.name: s.model for s in scn.models}
            tables = core.build_tables(models, core.SYSTEMS[system])
            rows.append(plain(tables))
            for s in scn.models:
                t = tables[s.model.name]
                cm = port_cm if pkg == "port" else ref_cm
                rows.append([cm.effective_deadline(s.period_s, t),
                             cm.effective_deadline(s.period_s, t, 0.02),
                             cm.effective_deadline(s.period_s, t, None,
                                                   s.model)])
        out[pkg] = rows
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("tokens", [1.0, 7.5, 24.0])
def test_genai_helpers_equal(tokens):
    for cap_idx in range(3):
        rg = ref_zoo.chat_llm()
        pg = port_zoo.chat_llm()
        rg, pg = ((rg, *rg.variants)[cap_idx], (pg, *pg.variants)[cap_idx])
        rt = ref_cm.build_cost_table(rg, ref_types.SYSTEMS["4K_1WS2OS"])
        pt = port_cm.build_cost_table(pg, port_types.SYSTEMS["4K_1WS2OS"])
        assert (port_cm.genai_expected_tokens(pg.genai)
                == ref_cm.genai_expected_tokens(rg.genai))
        assert np.array_equal(port_cm.genai_iso_s(pt, pg.genai, tokens),
                              ref_cm.genai_iso_s(rt, rg.genai, tokens))
        assert (port_cm.effective_deadline(0.5, pt, graph=pg)
                == ref_cm.effective_deadline(0.5, rt, graph=rg))
        assert pg.genai_path(int(tokens)) == rg.genai_path(int(tokens))


TRANSFER_MODELS = [
    {},
    {"bandwidth_bytes_s": 0.0},
    {"bandwidth_bytes_s": 5e8, "base_latency_s": 1e-4},
    {"link_bandwidth_bytes_s": 2e8},
    {"bandwidth_bytes_s": 3e9, "link_bandwidth_bytes_s": 1e9,
     "energy_per_byte_j": 5e-11},
]


@pytest.mark.parametrize("cfg", TRANSFER_MODELS, ids=range(len(TRANSFER_MODELS)))
def test_transfer_costs_equal(cfg):
    """``TransferModel``'s costs and config, and ``ContendedLinks`` over a
    seeded sequence of transfers on three node pairs."""
    rm, pm = ref_cm.TransferModel(**cfg), port_cm.TransferModel(**cfg)
    assert (pm.enabled, pm.contended, pm.wire_bandwidth_bytes_s) == (
        rm.enabled, rm.contended, rm.wire_bandwidth_bytes_s)
    assert pm.to_config() == rm.to_config()
    assert port_cm.TransferModel.from_config(pm.to_config()) == pm
    rl, pl = ref_cm.ContendedLinks(rm), port_cm.ContendedLinks(pm)
    rng = np.random.default_rng(5)
    t = 0.0
    for _ in range(40):
        a, b = (int(v) for v in rng.integers(0, 3, 2))
        nbytes = float(rng.uniform(1e3, 5e7))
        t += float(rng.exponential(0.02))
        assert plain(pm.transfer_s(nbytes)) == plain(rm.transfer_s(nbytes))
        assert pm.transfer_j(nbytes) == rm.transfer_j(nbytes)
        got, want = pl.transfer(a, b, nbytes, t), rl.transfer(a, b, nbytes, t)
        assert plain(got) == plain(want)
    assert (pl.n_transfers, pl.n_queued, plain(pl.queued_s)) == (
        rl.n_transfers, rl.n_queued, plain(rl.queued_s))
    if math.isfinite(pm.link_bandwidth_bytes_s):
        assert pl.n_queued > 0


def _mapscore_inputs(rng, table, n_accs, case):
    n = table.lat.shape[1]
    nxt = int(rng.integers(0, n))
    remaining = np.arange(nxt, n)[rng.random(n - nxt) < 0.7]
    if case == "urgency_clamp":                  # the whole model to go
        nxt, remaining = 0, np.arange(n)
    t_curr = float(rng.uniform(0.0, 1.0))
    togo = float(table.lat_mean[remaining].sum())
    deadline = {
        "random": t_curr + float(rng.uniform(0.0, 0.1)),
        "no_slack": t_curr + 5e-7,               # slack <= 1e-6: urgency 0
        "late": t_curr - 0.01,
        "urgency_clamp": t_curr + max(togo / 40.0, 2e-6),
    }.get(case, t_curr + 0.05)
    t_cmpl = {"starv_clamp": t_curr - 10.0}.get(
        case, t_curr - float(rng.uniform(0.0, 0.01)))
    prev = rng.uniform(0.0, 1e6, n_accs)
    if case == "cswitch_clamp":
        prev = np.full(n_accs, 1e12)
    same = rng.random(n_accs) < 0.3
    return nxt, remaining, t_curr, t_cmpl, deadline, prev, same


MAPSCORE_CASES = ["random", "no_slack", "late", "urgency_clamp",
                  "starv_clamp", "cswitch_clamp"]


@pytest.mark.parametrize("case", MAPSCORE_CASES)
@pytest.mark.parametrize("builder", ["kws_res8", "ofa", "chat_llm", "gnmt"])
def test_mapscore_equal(builder, case):
    """Algorithm 1's vector on seeded inputs, each clamp driven, the
    ToGo helpers, and the clamp constants."""
    assert (port_ms.URGENCY_MAX, port_ms.STARV_MAX, port_ms.CSWITCH_MAX,
            port_ms._EPS_SLACK) == (ref_ms.URGENCY_MAX, ref_ms.STARV_MAX,
                                    ref_ms.CSWITCH_MAX, ref_ms._EPS_SLACK)
    rt = ref_cm.build_cost_table(ref_zoo.ZOO_BUILDERS[builder](),
                                 ref_types.SYSTEMS["4K_1WS2OS"])
    pt = port_cm.build_cost_table(port_zoo.ZOO_BUILDERS[builder](),
                                  port_types.SYSTEMS["4K_1WS2OS"])
    rng = np.random.default_rng(MAPSCORE_CASES.index(case))
    for k in range(25):
        nxt, rem, t, tc, dl, prev, same = _mapscore_inputs(rng, rt, 3, case)
        ab = (float(rng.uniform(0, 2)), float(rng.uniform(0, 2)))
        override = float(rng.uniform(0, 0.1)) if k % 5 == 4 else None
        want = ref_ms.mapscore(rt, nxt, rem, t, tc, dl, prev, same,
                               ref_ms.MapScoreParams(*ab), override)
        got = port_ms.mapscore(pt, nxt, rem, t, tc, dl, prev, same,
                               port_ms.MapScoreParams(*ab), override)
        assert got.tobytes() == want.tobytes() and got.dtype == want.dtype
        for fn in ("togo_seconds", "min_togo_seconds"):
            assert (getattr(port_ms, fn)(pt, rem).hex()
                    == getattr(ref_ms, fn)(rt, rem).hex())
    empty = np.zeros(0, np.int64)
    assert port_ms.togo_seconds(pt, empty) == 0.0
    assert port_ms.min_togo_seconds(pt, empty) == 0.0


def test_mapscore_cases_reach_their_clamps():
    """The inputs of ``test_mapscore_equal`` do drive what they name."""
    t = ref_cm.build_cost_table(ref_zoo.kws_res8(),
                                ref_types.SYSTEMS["4K_1WS2OS"])
    p0 = ref_ms.MapScoreParams(0.0, 0.0)
    p_starv, p_en = ref_ms.MapScoreParams(1.0, 0.0), ref_ms.MapScoreParams(0.0, 1.0)
    rng = np.random.default_rng(MAPSCORE_CASES.index("no_slack"))
    nxt, rem, tc_, tcm, dl, prev, same = _mapscore_inputs(rng, t, 3, "no_slack")
    assert not ref_ms.mapscore(t, nxt, rem, tc_, tcm, dl, prev, same, p0).any()
    rng = np.random.default_rng(MAPSCORE_CASES.index("urgency_clamp"))
    nxt, rem, tc_, tcm, dl, prev, same = _mapscore_inputs(rng, t, 3,
                                                          "urgency_clamp")
    got = ref_ms.mapscore(t, nxt, rem, tc_, tcm, dl, prev, same, p0)
    assert np.allclose(got, ref_ms.URGENCY_MAX * t.lat_sum[nxt]
                       / t.lat[:, nxt])
    rng = np.random.default_rng(MAPSCORE_CASES.index("starv_clamp"))
    nxt, rem, tc_, tcm, dl, prev, same = _mapscore_inputs(rng, t, 3,
                                                          "starv_clamp")
    d = (ref_ms.mapscore(t, nxt, rem, tc_, tcm, dl, prev, same, p_starv)
         - ref_ms.mapscore(t, nxt, rem, tc_, tcm, dl, prev, same, p0))
    assert np.allclose(d, ref_ms.STARV_MAX)
    rng = np.random.default_rng(MAPSCORE_CASES.index("cswitch_clamp"))
    nxt, rem, tc_, tcm, dl, prev, same = _mapscore_inputs(rng, t, 3,
                                                          "cswitch_clamp")
    same[:] = False
    d = (ref_ms.mapscore(t, nxt, rem, tc_, tcm, dl, prev, same, p_en)
         - ref_ms.mapscore(t, nxt, rem, tc_, tcm, dl, prev, same, p0))
    assert np.allclose(d, t.en_sum[nxt] / t.en[:, nxt] - ref_ms.CSWITCH_MAX)


@pytest.mark.parametrize("overrides", [{}, {"soa_slab": False},
                                       {"fast_path": False, "soa_batch_min": 2},
                                       {"lazy_peek": False,
                                        "vectorized_router": False}])
@pytest.mark.parametrize("engine", ["soa", "scalar"])
def test_engine_presets_equal(engine, overrides):
    assert port_engine.ENGINE_PRESETS == ref_engine.ENGINE_PRESETS
    rc = ref_engine.EngineConfig(engine, **overrides)
    pc = port_engine.EngineConfig(engine, **overrides)
    assert pc.resolve() == rc.resolve()
    assert port_engine.EngineConfig.make(engine) == port_engine.EngineConfig(engine)
    assert port_engine.EngineConfig.make(None) is None
    core = PACKAGES["port"][0]
    sim = core.Simulator(core.build_scenario("AR_Call"), "4K_1WS2OS",
                         core.dream_full(), duration_s=0.1, engine=pc)
    want = pc.resolve()
    assert sim.soa_slab is want["soa_slab"]
    assert sim.scheduler.fast_path is want["fast_path"]
    assert sim.scheduler.soa_batch_min == want["soa_batch_min"]

    class Fleet:
        policy = type("P", (), {"vectorized": None})()
    fleet = Fleet()
    pc.apply_fleet(fleet)
    assert (fleet.lazy_peek, fleet.policy.vectorized) == (
        want["lazy_peek"], want["vectorized_router"])


def test_engine_refuses_an_unknown_preset():
    with pytest.raises(ValueError, match="unknown engine preset"):
        port_engine.EngineConfig("fast")
