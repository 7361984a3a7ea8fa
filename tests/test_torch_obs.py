"""The port's observability bundle (``repro_torch.obs``) against the JAX
package's (``repro.obs``): the same operations give byte-equal Prometheus
text, JSON snapshots and span JSONL, the same parser verdicts and the same
error messages; the critical-path extractor and the report renderer give
equal output on span records that the reference's fleet simulator writes
with observability on. Everything here is exact: no tolerance."""
import itertools
import json
import time

import pytest

import repro.obs as ref_obs
import repro.obs.report as ref_report
import repro_torch.obs as port_obs
import repro_torch.obs.report as port_report
from repro.cluster import FleetSimulator, TransferModel

from test_cluster import cascade_fleet
from test_slo import SLO_CFG, tiered_fleet

MODS = (ref_obs, port_obs)


def _outcome(fn):
    """(``"ok"``, value) or (exception type name, message): what a call did,
    comparable across the two packages."""
    try:
        return "ok", fn()
    except Exception as e:          # noqa: BLE001 - the verdict is compared
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _registry_ops(mod):
    """One fixed sequence of registry operations; returns the registry."""
    reg = mod.MetricsRegistry()
    c = reg.counter("frames_total", "frames", ("node", "model"))
    c.inc(3, node=0, model="det")
    c.inc(2.5, node=0, model="det")
    c.inc(1, node=1, model='kws"x\\y\nz')        # every escape
    c.inc(0, node=2, model="")
    g = reg.gauge("pressure", "controller pressure")
    g.set(0.25)
    g.inc(0.5)
    g.inc(-1e-7)
    reg.gauge("router_weight", "weights", ("name",)).set(1e21, name="load")
    reg.gauge("router_weight", "weights", ("name",)).set(
        float("inf"), name="xfer")
    h = reg.histogram("latency_seconds", "latency", buckets=(0.1, 1.0, 2.5))
    for v in (0.05, 0.1, 0.5, 5.0, 1e-9):
        h.observe(v)
    hl = reg.histogram("wait_seconds", "wait", ("tier",), buckets=(0.5,))
    hl.observe(0.2, tier="gold")
    hl.observe(0.7, tier="best_effort")
    reg.counter("empty_total", "never incremented")
    return reg


def test_registry_prometheus_json_and_snapshot_byte_equal(tmp_path):
    out = []
    for i, mod in enumerate(MODS):
        reg = _registry_ops(mod)
        path = tmp_path / f"m{i}.json"
        reg.dump_json(str(path))
        out.append((reg.to_prometheus(), path.read_bytes(), reg.snapshot(),
                    len(reg), [m.name for m in reg]))
    assert out[0] == out[1]
    assert out[0][0].startswith("# HELP")            # not vacuous


def test_empty_registry_exports_equal():
    assert ref_obs.MetricsRegistry().to_prometheus() == \
        port_obs.MetricsRegistry().to_prometheus() == ""
    assert ref_obs.MetricsRegistry().snapshot() == \
        port_obs.MetricsRegistry().snapshot() == {}


@pytest.mark.parametrize("case", [
    "kind_mismatch", "label_set_mismatch", "missing_label", "extra_label",
    "counter_down", "bad_name", "bad_label_name", "value_and_inc"])
def test_registry_rejections_equal(case):
    def run(mod):
        reg = mod.MetricsRegistry()
        c = reg.counter("x_total", "x", ("a",))
        g = reg.gauge("g", "g", ("a",))
        ops = {
            "kind_mismatch": lambda: reg.gauge("x_total", "x"),
            "label_set_mismatch": lambda: reg.counter("x_total", "x", ("b",)),
            "missing_label": lambda: c.inc(1),
            "extra_label": lambda: c.inc(1, a=1, b=2),
            "counter_down": lambda: c.inc(-1, a=1),
            "bad_name": lambda: reg.counter("bad name", "x"),
            "bad_label_name": lambda: reg.counter("y_total", "y", ("0a",)),
            "value_and_inc": lambda: (c.inc(2, a="u"), g.inc(3, a="v"),
                                      c.value(a="u"), g.value(a="v"),
                                      c.value(a="never")),
        }
        return _outcome(ops[case])
    got = [run(mod) for mod in MODS]
    assert got[0] == got[1]
    if case != "value_and_inc":
        assert got[0][0] == "MetricsError"


# ---------------------------------------------------------------------------
# parse_prometheus: results and rejections
# ---------------------------------------------------------------------------

PROM_TEXTS = [
    # accepted
    "",
    "# HELP a_total frames\n# TYPE a_total counter\na_total 3\n",
    'm{a="1",b="x\\"y\\\\z\\n"} 2.5\n',
    "m{} 1\nm  -Inf\n\n  m 1e21\n",
    'm{a="1",} 7\n',
    "# TYPE s summary\n# TYPE u untyped\nu 1\n",
    # the reference takes label pairs with no comma between them, and so
    # does the copy
    'm{a="1" b="2"} 1\n',
    # rejected
    "what even is this line\n",
    "ok_metric not_a_number\n",
    "m NaN\n",
    "# BOGUS comment\n",
    "# TYPE m\n",
    "# TYPE m widget\n",
    "#\n",
    'm{a=1} 1\n',
    '0m 1\n',
    'm{a="unterminated} 1\n',
]


@pytest.mark.parametrize("text", PROM_TEXTS)
def test_parse_prometheus_equal_verdicts(text):
    got = [_outcome(lambda: mod.parse_prometheus(text)) for mod in MODS]
    assert got[0] == got[1]


def test_parse_prometheus_accepts_and_rejects_as_documented():
    verdicts = [_outcome(lambda: port_obs.parse_prometheus(t))[0]
                for t in PROM_TEXTS]
    assert verdicts[:7] == ["ok"] * 7
    assert verdicts[7:] == ["MetricsError"] * (len(PROM_TEXTS) - 7)


def test_parse_prometheus_roundtrips_both_exports():
    for mod in MODS:
        text = _registry_ops(mod).to_prometheus()
        for parser in MODS:
            assert parser.parse_prometheus(text) == \
                ref_obs.parse_prometheus(text)


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

def _trace_ops(mod):
    tr = mod.SpanTracer()
    a = tr.open("job", 0.5, uid="j0", model="det")
    b = tr.open("job", 0.25, uid="j1")
    tr.event("place", 0.1, stream=1, node="big", policy="tuned_score")
    tr.span("xfer", 0.3, 0.4, src=0, dst=1, nbytes=1024, joules=1e-7)
    tr.close(a, 0.75, outcome="done", energy=0.125)
    tr.event("epoch", 2, dlv=0.0, uxcost=float("inf"), frames=3)
    tr.open("job", 0.9, uid="j2")
    tr.open("job", 3.0, uid="j3", outcome="kept")
    tr.finish(1.0)
    del b
    return tr


def test_span_jsonl_and_records_byte_equal(tmp_path):
    out = []
    for i, mod in enumerate(MODS):
        tr = _trace_ops(mod)
        path = tmp_path / f"s{i}.jsonl"
        n = tr.dump_jsonl(str(path))
        out.append((n, len(tr), path.read_bytes(), tr.to_records(),
                    mod.load_jsonl(str(path))))
    assert out[0] == out[1]
    assert out[0][0] == 7


@pytest.mark.parametrize("rec", [
    {"sid": 0, "kind": "job", "t0": 0.0, "t1": 1.0, "attrs": {}},
    [1, 2],
    {"sid": 0, "kind": "job", "t0": 0.0, "t1": 1.0},
    {"sid": "0", "kind": "job", "t0": 0.0, "t1": 1.0, "attrs": {}},
    {"sid": 0, "kind": "", "t0": 0.0, "t1": 1.0, "attrs": {}},
    {"sid": 0, "kind": "job", "t0": "0", "t1": 1.0, "attrs": {}},
    {"sid": 0, "kind": "job", "t0": 2.0, "t1": 1.0, "attrs": {}},
    {"sid": 0, "kind": "job", "t0": 0.0, "t1": 1.0, "attrs": []},
])
def test_validate_span_equal_verdicts(rec):
    got = [_outcome(lambda: mod.validate_span(rec)) for mod in MODS]
    assert got[0] == got[1]


def test_span_close_unknown_equal():
    got = []
    for mod in MODS:
        tr = mod.SpanTracer()
        sid = tr.open("job", 0.0)
        tr.close(sid, 1.0)
        got.append((_outcome(lambda: tr.close(99, 1.0)),
                    _outcome(lambda: tr.close(sid, 2.0))))
    assert got[0] == got[1]
    assert got[0][0][0] == "SpanError"


# ---------------------------------------------------------------------------
# critical paths over the reference fleet's span records
# ---------------------------------------------------------------------------

def _fleet_records(case):
    if case == "whole":
        fs = FleetSimulator(cascade_fleet(), "score", duration_s=1.5, seed=3,
                            obs=True)
    elif case == "stage_split":
        fs = FleetSimulator(cascade_fleet(), "score", duration_s=1.5, seed=3,
                            obs=True, split_stages=True,
                            transfer=TransferModel(
                                link_bandwidth_bytes_s=1.25e9))
    else:
        fs = FleetSimulator(tiered_fleet(), "score", duration_s=1.0, seed=3,
                            slo=SLO_CFG, slo_every_s=0.1, obs=True)
    r = fs.run()
    return fs, r, fs.obs.tracer.to_records()


@pytest.mark.parametrize("case", ["whole", "stage_split", "slo_overload"])
def test_critical_path_and_tails_equal_on_fleet_records(case, tmp_path):
    fs, r, recs = _fleet_records(case)
    # the records also go through the port's JSONL round trip unchanged
    path = tmp_path / "spans.jsonl"
    fs.obs.tracer.dump_jsonl(str(path))
    assert port_obs.load_jsonl(str(path)) == recs
    tails = [mod.pipeline_tails(recs) for mod in MODS]
    assert tails[0] == tails[1]
    assert len(tails[1]) == r.pipe_frames > 0
    for tail in tails[1]:
        uid = tail["attrs"]["uid"]
        paths = [mod.critical_path(recs, tail_uid=uid) for mod in MODS]
        assert paths[0] == paths[1]
    # the default tail (the slowest), and a rejected one
    assert ref_obs.critical_path(recs) == port_obs.critical_path(recs)
    bad = [_outcome(lambda: mod.critical_path(recs, tail_uid="no-such-job"))
           for mod in MODS]
    assert bad[0] == bad[1] and bad[0][0] == "SpanError"


def test_critical_path_requires_done_tail_equal():
    rec = [{"sid": 0, "kind": "job", "t0": 0.0, "t1": 1.0,
            "attrs": {"uid": "j0", "tail": False, "outcome": "done"}}]
    got = [_outcome(lambda: mod.critical_path(rec)) for mod in MODS]
    assert got[0] == got[1] and got[0][0] == "SpanError"


# ---------------------------------------------------------------------------
# profiler and report
# ---------------------------------------------------------------------------

def _profile_ops(mod, monkeypatch):
    """The same metering calls on a clock that ticks 0.001 s a read."""
    clock = itertools.count(1)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock) * 1e-3)
    prof = mod.HotLoopProfiler()
    prof.start_run()
    prof.start_run()                          # idempotent
    for key in ("fleet.stream", "node.arrival", "fleet.stream", "node.done",
                "node.arrival", "fleet.stream"):
        t0 = prof.t0()
        prof.add(key, t0)
        prof.add(key, prof.t0() - 0.002)
    prof.stop_run()
    prof.stop_run()
    return (prof.snapshot(), prof.table(2), prof.table(), prof.top(2),
            prof.streams_per_wall_s(3.0))


def test_profiler_snapshot_table_equal(monkeypatch):
    got = [_profile_ops(mod, monkeypatch) for mod in MODS]
    assert got[0] == got[1]
    snap = got[1][0]
    assert set(snap) == {"total_wall_s", "keys"}
    assert set(snap["keys"]) == {"fleet.stream", "node.arrival", "node.done"}
    assert snap["keys"]["fleet.stream"]["count"] == 6
    assert all(set(v) == {"wall_s", "count"} for v in snap["keys"].values())
    empty = [mod.HotLoopProfiler() for mod in MODS]
    assert [p.table() for p in empty] == ["(no profile samples)"] * 2
    assert [p.streams_per_wall_s(1.0) for p in empty] == [0.0, 0.0]


def test_render_report_equal_on_fleet_artifacts():
    fs, _, recs = _fleet_records("slo_overload")
    metrics = fs.obs.metrics.snapshot()
    profile = fs.obs.profiler.snapshot()
    args = [(recs, metrics, profile), (recs, None, None),
            (None, metrics, None), (None, None, profile),
            (None, None, {"total_wall_s": 0.0, "keys": {}})]
    for a in args:
        texts = [mod.render_report(*a, title="T") for mod in
                 (ref_report, port_report)]
        assert texts[0] == texts[1]
    full = port_report.render_report(recs, metrics, profile, title="T")
    for section in ("# T", "## Fleet timeline",
                    "## Slowest pipelines (critical paths)",
                    "## Pressure-law attribution", "## Per-tier DLV",
                    "## Hot-loop profile"):
        assert section in full
    for name in ("render_timeline", "render_pressure",
                 "render_critical_paths"):
        assert getattr(ref_report, name)(recs) == \
            getattr(port_report, name)(recs)
    assert ref_report.render_tier_dlv(metrics) == \
        port_report.render_tier_dlv(metrics)
    assert ref_report.render_profile(profile) == \
        port_report.render_profile(profile)


# ---------------------------------------------------------------------------
# the Obs bundle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arg", [None, False, True, {"profile": False},
                                 {"spans": False, "metrics": True},
                                 {"spans": True, "metrics": False,
                                  "profile": False}])
def test_obs_make_selects_the_same_facilities(arg):
    got = []
    for mod in MODS:
        obs = mod.Obs.make(arg)
        got.append(None if obs is None else
                   (obs.tracer is not None, obs.metrics is not None,
                    obs.profiler is not None))
    assert got[0] == got[1]
    for mod in MODS:
        with pytest.raises(TypeError):
            mod.Obs.make("yes")
        same = mod.Obs.make(True)
        assert mod.Obs.make(same) is same


def test_obs_export_writes_equal_files(tmp_path, monkeypatch):
    out = []
    for i, mod in enumerate(MODS):
        clock = itertools.count(1)
        monkeypatch.setattr(time, "perf_counter",
                            lambda: next(clock) * 1e-3)
        obs = mod.Obs.make(True)
        obs.tracer.event("place", 0.0, stream=0, node="big")
        obs.tracer.span("epoch", 0.0, 1.0, dlv=0.25, frames=4)
        obs.tracer.finish(1.0)
        obs.metrics.counter("serve_frames_total", "frames served",
                            ("node", "model")).inc(4, node="big",
                                                   model="kws")
        obs.profiler.start_run()
        obs.profiler.add("fleet.place", obs.profiler.t0())
        obs.profiler.stop_run()
        d = tmp_path / str(i)
        paths = obs.export(str(d))
        out.append({k: (p[len(str(d)):], open(p, "rb").read())
                    for k, p in paths.items()})
    assert out[0] == out[1]
    assert set(out[1]) == {"spans", "metrics_prom", "metrics_json",
                           "profile"}
    assert json.loads(out[1]["profile"][1])["keys"]["fleet.place"][
        "count"] == 1

