"""The port's serving engine against the JAX package's.

The scheduling code is plain Python and numpy on both sides, so on the same
inputs (a hand-set latency table, the same seeds) the two must take the
same decisions and produce the same numbers exactly. The wall-clock run is
held to the sanity checks of tests/test_serving.py.
"""
import numpy as np
import pytest

from repro import serving as js
from repro_torch import serving as ts
from repro_torch.launch.serve import build_handle

STREAMS = [
    # model, fps, batch, seq, vocab, extra
    ("det", 8, 1, 16, 128, {}),
    ("ver", 8, 2, 8, 64, {"depends_on": "det", "trigger_prob": 0.5}),
    ("ctx", 4, 1, 32, 256000, {"deadline_frac": 0.5}),
]


def _queues():
    out = []
    for mod in (js, ts):
        q = mod.RequestQueue(clock=lambda: 0.0)
        for model, fps, b, s, v, extra in STREAMS:
            q.add_stream(model, fps, b, s, v, **extra)
        out.append(q)
    return out


def _same(a, b):
    assert (a.model, a.arrival, a.deadline, a.depends_on) == \
        (b.model, b.arrival, b.deadline, b.depends_on)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_request_queue_matches_reference():
    jq, tq = _queues()
    for now in (0.0, 0.3, 0.31, 1.7):
        jout, tout = jq.poll(now), tq.poll(now)
        assert len(jout) == len(tout)
        for a, b in zip(jout, tout):
            _same(a, b)
        for t in (now, now + 0.01):
            jd, td = jq.trigger_dependents("det", t), tq.trigger_dependents("det", t)
            assert len(jd) == len(td)
            for a, b in zip(jd, td):
                _same(a, b)
    assert len(jq.pending) == len(tq.pending) > 10


class _Stub:
    """Just enough of a ModelHandle for the scheduling functions."""

    def __init__(self, name, supernet=()):
        self.name, self.supernet = name, supernet


LAT = {"det": 0.004, "det@v1": 0.002, "det@v2": 0.0008, "ctx": 0.02}


def _engines(**kw):
    out = []
    for mod in (js, ts):
        accs = [mod.VirtualAccelerator("big", speed=1.0, power=1.0),
                mod.VirtualAccelerator("small", speed=0.5, power=0.4,
                                       last_model="det")]
        eng = mod.ServingEngine(accs, seed=3, **kw)
        for name, lat in LAT.items():
            sup = ("det@v1", "det@v2") if name == "det" else ()
            eng.models[name] = _Stub(name, sup)
            eng.drop_hist[name] = []
            for acc in accs:
                eng.lat_table[(name, acc.name)] = lat / acc.speed
        out.append(eng)
    return out


def _requests(mod):
    return [mod.ServeRequest(rid=i, model=m, tokens=np.zeros((1, 4), np.int32),
                             arrival=arr, deadline=dl)
            for i, (m, arr, dl) in enumerate([
                ("det", 0.0, 0.005), ("ctx", 0.001, 0.015),
                ("det", 0.002, 0.003), ("ctx", 0.0, 0.5),
                ("det@v1", 0.0, 0.01)])]


def test_mapscore_matches_reference():
    je, te = _engines()
    for now in (0.0, 0.002, 0.0049, 0.2):
        for jr, tr in zip(_requests(js), _requests(ts)):
            for ja, ta in zip(je.accs, te.accs):
                assert je._mapscore(jr, ja, now) == te._mapscore(tr, ta, now)


def test_try_drop_matches_reference():
    je, te = _engines()
    for now in (0.0, 0.004, 0.02):
        je._waiting, te._waiting = _requests(js), _requests(ts)
        je._try_drop(now)
        te._try_drop(now)
        assert [r.dropped for r in je._waiting] == \
            [r.dropped for r in te._waiting]
        assert je.dropped == te.dropped
    assert te.dropped > 0


def test_pick_variant_matches_reference():
    je, te = _engines()
    for dl in (1e-6, 0.0009, 0.003, 0.005, 60.0):
        jr = js.ServeRequest(rid=0, model="det", tokens=None, arrival=0.0,
                             deadline=dl)
        tr = ts.ServeRequest(rid=0, model="det", tokens=None, arrival=0.0,
                             deadline=dl)
        assert je._pick_variant(jr, 0.0) == te._pick_variant(tr, 0.0)
    assert te._pick_variant(tr, 0.0) == "det"


def test_seeded_adapt_matches_reference():
    je, te = _engines()
    for ux in (0.9, 0.5, 1.3, 0.7, 0.2, 0.4, 0.8, 1.1, 0.3):
        je._adapt(ux)
        te._adapt(ux)
        assert (je.params.alpha, je.params.beta) == \
            (te.params.alpha, te.params.beta)
        assert je._probe_radius == te._probe_radius


def test_end_to_end_run_with_cascade_on_cpu():
    accs = [ts.VirtualAccelerator("a0", speed=1.0, power=1.0),
            ts.VirtualAccelerator("a1", speed=0.5, power=0.5)]
    eng = ts.ServingEngine(accs, adaptivity=True, frame_drop=True,
                           supernet_switch=False)
    parent = build_handle("gemma-2b", "parent", layers=1, device="cpu")
    child = build_handle("mamba2-130m", "child", layers=1, device="cpu")
    for h in (parent, child):
        eng.register(h, np.zeros((1, 16), np.int32))
        assert all(eng.lat_table[(h.name, a.name)] > 0 for a in accs)
    q = ts.RequestQueue(clock=lambda: 0.0)
    q.add_stream("parent", fps=6, batch=1, seq=16, vocab=64)
    q.add_stream("child", fps=6, batch=1, seq=16, vocab=64,
                 depends_on="parent", trigger_prob=1.0)
    report = eng.run(q, duration_s=2.0)
    assert report.frames > 0
    assert report.per_model.get("parent", {}).get("frames", 0) > 0
    # every completed parent triggers a child (prob 1.0)
    assert report.per_model.get("child", {}).get("frames", 0) > 0
    assert 0.0 <= report.dlv_rate <= 1.0
    served = [r for r in q.pending if r.result is not None]
    assert served and all(tuple(r.result.shape) == (1, 16, 128)
                          for r in served)


# ---------------------------------------------------------------------------
# arrival processes and trace replay (tests/test_serving.py's, mirrored, and
# held equal to the JAX package's queue on the same seeds)
# ---------------------------------------------------------------------------

from repro.scenarios import arrivals as jarr  # noqa: E402
from repro.scenarios import trace as jtrace  # noqa: E402
from repro_torch.scenarios import arrivals as tarr  # noqa: E402
from repro_torch.scenarios import trace as ttrace  # noqa: E402

#: one config per process kind, away from the defaults where it has any
ARRIVALS = {
    "periodic": {"kind": "periodic"},
    "periodic@phase": {"kind": "periodic", "phase_frac": 0.25},
    "periodic_jitter": {"kind": "periodic_jitter", "jitter": 0.3},
    "poisson": {"kind": "poisson", "rate_scale": 1.5},
    "bursty": {"kind": "bursty", "on_s": 0.2, "off_s": 0.4,
               "burst_factor": 3.0},
    "diurnal": {"kind": "diurnal", "amplitude": 0.6, "day_s": 1.5,
                "phase": 0.1},
    "triggered": {"kind": "triggered"},
}


def test_every_arrival_kind_is_ported():
    assert tarr.arrival_kinds() == jarr.arrival_kinds()
    assert {c["kind"] for c in ARRIVALS.values()} == set(tarr.arrival_kinds())


@pytest.mark.parametrize("name", sorted(ARRIVALS))
def test_arrival_process_draws_equal_the_reference(name):
    """start / next_after on the same generator seeds: the same times bit
    for bit, the same config back, and the generators left in the same
    state."""
    cfg = ARRIVALS[name]
    jp, tp = jarr.arrival_from_config(cfg), tarr.arrival_from_config(cfg)
    assert tp.to_config() == jp.to_config()
    for index, period in ((0, 0.1), (3, 1 / 12)):
        jr, tr = np.random.default_rng(index), np.random.default_rng(index)
        jt, tt = jp.start(index, period, jr), tp.start(index, period, tr)
        seen = []
        for _ in range(200):
            assert jt == tt
            if tt is None:
                break
            seen.append(tt)
            jt, tt = jp.next_after(jt, period, jr), tp.next_after(tt, period, tr)
        assert jr.random() == tr.random()
        assert (len(seen) == 0) == (cfg["kind"] == "triggered")


@pytest.mark.parametrize("name", sorted(ARRIVALS))
def test_queue_with_arrival_process_matches_reference(name):
    """The same streams on both queues, the process given as a config dict
    to one head stream and as an instance to another: the same requests
    (times, deadlines, tokens) at every poll, and dependents unaffected."""
    cfg = ARRIVALS[name]
    queues = []
    for mod, arr in ((js, jarr), (ts, tarr)):
        q = mod.RequestQueue(clock=lambda: 0.0)
        q.add_stream("det", 8, 1, 16, 128, arrival=cfg)
        q.add_stream("ver", 8, 2, 8, 64, depends_on="det", trigger_prob=0.5,
                     arrival=cfg)
        q.add_stream("ctx", 4, 1, 32, 256000, deadline_frac=0.5,
                     arrival=arr.arrival_from_config(cfg))
        queues.append(q)
    jq, tq = queues
    for now in (0.0, 0.3, 0.31, 1.7, 3.0):
        jout, tout = jq.poll(now), tq.poll(now)
        assert len(jout) == len(tout)
        for a, b in zip(jout, tout):
            _same(a, b)
        jd, td = jq.trigger_dependents("det", now), tq.trigger_dependents("det", now)
        assert len(jd) == len(td)
        for a, b in zip(jd, td):
            _same(a, b)
    assert len(jq.pending) == len(tq.pending)
    heads = [r for r in tq.pending if r.depends_on is None]
    assert (len(heads) == 0) == (cfg["kind"] == "triggered")


def test_queue_arrival_process_streams():
    """A Poisson stream drives the queue; draws are reproducible (crc32
    seed) and not periodic (tests/test_serving.py's check)."""
    def emitted():
        q = ts.RequestQueue(clock=lambda: 0.0)
        q.add_stream("m", fps=100, batch=1, seq=4, vocab=8,
                     arrival=tarr.Poisson().to_config())
        return [r.arrival for r in q.poll(1.0)]

    ts_ = emitted()
    assert len(ts_) > 10
    assert ts_ == emitted()
    assert np.std(np.diff(ts_)) > 1e-4


def test_queue_without_arrival_stays_strictly_periodic():
    q = ts.RequestQueue(clock=lambda: 0.0)
    q.add_stream("m", fps=10, batch=1, seq=4, vocab=8)
    assert q.streams["m"]["arrival"] is None
    want = [0.0]
    while want[-1] + 0.1 <= 2.0:
        want.append(want[-1] + 0.1)
    assert [r.arrival for r in q.poll(2.0)] == want


def test_request_queue_copies_arrival_instances():
    """Stateful arrival processes are never shared between streams."""
    shared = tarr.BurstyOnOff(on_s=0.3, off_s=0.3, burst_factor=2.0)
    q = ts.RequestQueue(clock=lambda: 0.0)
    q.add_stream("a", fps=10, batch=1, seq=8, vocab=16, arrival=shared)
    q.add_stream("b", fps=10, batch=1, seq=8, vocab=16, arrival=shared)
    assert q.streams["a"]["arrival"] is not q.streams["b"]["arrival"]
    assert q.streams["a"]["arrival"] is not shared


@pytest.fixture(scope="module")
def sim_trace_text():
    """A trace the JAX simulator recorded (AR_Call, 1 s), as JSONL text."""
    from repro.core import build_scenario, dream_full
    from repro.core.simulator import Simulator
    sim = Simulator(build_scenario("AR_Call", 0.5), "4K_1WS2OS", dream_full(),
                    duration_s=1.0, seed=0, record=True)
    sim.run()
    return jtrace.dumps(sim.trace)


def test_trace_from_the_simulator_loads_unchanged(sim_trace_text, tmp_path):
    path = tmp_path / "run.jsonl"
    path.write_text(sim_trace_text)
    got = ttrace.load_trace(str(path))
    want = jtrace.loads(sim_trace_text)
    assert got.meta == want.meta and got.events == want.events
    assert got.arrivals_by_model() == want.arrivals_by_model()
    assert ttrace.dumps(got) == sim_trace_text


def test_trace_replay_queue_feeds_recorded_arrivals(sim_trace_text):
    """A simulator-recorded trace replays through the port's queue as
    through the JAX package's: the same requests, drained once, and the
    dependents still triggered live."""
    expected = jtrace.loads(sim_trace_text).arrivals_by_model()
    queues = []
    for mod, tr in ((js, jtrace), (ts, ttrace)):
        q = mod.TraceReplayQueue(clock=lambda: 0.0, trace=tr.loads(sim_trace_text))
        q.add_stream("kws_res8", fps=15, batch=1, seq=4, vocab=8)
        q.add_stream("translate_gnmt", fps=15, batch=1, seq=4, vocab=8,
                     depends_on="kws_res8", trigger_prob=1.0)
        queues.append(q)
    jq, tq = queues
    for now in (0.3, 1.0):
        jout, tout = jq.poll(now), tq.poll(now)
        assert len(jout) == len(tout)
        for a, b in zip(jout, tout):
            _same(a, b)
    assert [r.arrival for r in tq.pending] == expected["kws_res8"]
    assert all(r.model == "kws_res8" for r in tq.pending)
    assert tq.poll(1.0) == []
    assert len(tq.trigger_dependents("kws_res8", now=0.5)) == 1


def test_recorder_round_trips_a_live_queue():
    """Arrivals a live queue emitted, recorded and written out, replay as
    the same frames at the same times (the prompts differ: the live
    processes drew their gaps from the streams' generators)."""
    live = ts.RequestQueue(clock=lambda: 0.0)
    live.add_stream("det", 8, 1, 16, 128, arrival=ARRIVALS["poisson"])
    live.add_stream("ctx", 4, 1, 32, 512, arrival=ARRIVALS["bursty"])
    rec = ttrace.TraceRecorder({"scenario": "live"})
    for r in live.poll(2.0):
        rec.arrival(r.arrival, r.model)
    trace = ttrace.loads(ttrace.dumps(rec.trace()))
    assert trace.meta == {"scenario": "live", "version": ttrace.TRACE_VERSION}
    replay = ts.TraceReplayQueue(clock=lambda: 0.0, trace=trace)
    replay.add_stream("det", 8, 1, 16, 128)
    replay.add_stream("ctx", 4, 1, 32, 512)
    out = replay.poll(2.0)
    by_model = lambda rs, m: [r for r in rs if r.model == m]
    for m in ("det", "ctx"):
        a, b = by_model(live.pending, m), by_model(out, m)
        assert [r.arrival for r in a] == [r.arrival for r in b] and a
