"""The port's serving engine against the JAX package's.

The scheduling code is plain Python and numpy on both sides, so on the same
inputs (a hand-set latency table, the same seeds) the two must take the
same decisions and produce the same numbers exactly. The wall-clock run is
held to the sanity checks of tests/test_serving.py.
"""
import numpy as np

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
