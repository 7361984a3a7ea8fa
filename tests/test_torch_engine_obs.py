"""The serving engine's spans (``ServingEngine(obs=...)``): on a virtual
clock a traced run takes every decision a bare run takes and draws no
random number; one ``job`` span a frame, whose outcomes add up to the
report and whose segments tile it; one of each loop phase a dispatch,
the phases tiling the run without overlap; and under the CPU profiler the
spans, mapped through the run's clock pairs, hold the calls the profiler
saw."""
from __future__ import annotations

import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.obs import Obs, SpanTracer, critical_path, validate_span
from repro_torch.obs.spans import _job_segments
from repro_torch.serving import (ModelHandle, RequestQueue, ServingEngine,
                                 VirtualAccelerator)
from repro_torch.serving import engine as engine_mod

LOOP = ("engine.wait", "engine.decide", "engine.enqueue", "engine.sync",
        "engine.after")

#: seconds a call of each model takes on the virtual clock
LAT = {"det": 0.020, "det@v1": 0.008, "ver": 0.015, "ctx": 0.060}
#: streams: (model, fps, the parent a cascade stage follows) -- the first
#: load overloads the slices, so that frames are dropped and abandoned
LOADS = {
    "overload": [("det", 60.0, None), ("ver", 10.0, "det"),
                 ("ctx", 15.0, None)],
    "light": [("det", 10.0, None), ("ver", 10.0, "det"),
              ("ctx", 4.0, None)],
}


class VirtualTime:
    """The engine's ``time`` on a clock that moves only when a model call
    or a sleep moves it."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s

    time_ns = staticmethod(time.time_ns)


def _handle(name: str, clock: VirtualTime, supernet=()) -> ModelHandle:
    def fn(params, tokens):
        clock.t += LAT[name]
        return torch.zeros(tokens.shape[0], tokens.shape[1], 4)
    return ModelHandle(name=name, cfg=None, params={"w": torch.zeros(1)},
                       fn=fn, supernet=supernet)


def _virtual_run(monkeypatch, load: str, obs=None, seconds: float = 3.0):
    clock = VirtualTime()
    monkeypatch.setattr(engine_mod, "time", clock)
    eng = ServingEngine([VirtualAccelerator("big", 1.0, 1.0),
                         VirtualAccelerator("small", 0.5, 0.4)],
                        seed=11, obs=obs, obs_node=None)
    for name in LAT:
        eng.register(_handle(name, clock, ("det@v1",) if name == "det"
                             else ()), np.zeros((1, 8), np.int32))
    q = RequestQueue(clock=lambda: 0.0)
    for model, fps, parent in LOADS[load]:
        q.add_stream(model, fps=fps, batch=1, seq=8, vocab=64,
                     depends_on=parent, trigger_prob=0.5)
    report = eng.run(q, duration_s=seconds)
    return eng, q, report


def _traced(monkeypatch, load: str):
    obs = Obs(tracer=SpanTracer())
    eng, q, report = _virtual_run(monkeypatch, load, obs)
    return eng, q, report, obs.tracer.to_records()


@pytest.mark.parametrize("load", sorted(LOADS))
def test_traced_run_decides_as_the_bare_run(monkeypatch, load):
    bare, bq, want = _virtual_run(monkeypatch, load)
    traced, tq, got, records = _traced(monkeypatch, load)
    assert got == want
    assert [(r.model, r.completion, r.dropped) for r in tq.pending] == \
        [(r.model, r.completion, r.dropped) for r in bq.pending]
    assert traced.lat_samples == bare.lat_samples
    assert len(records) > 4 * sum(map(len, traced.lat_samples.values()))
    if load == "overload":
        assert want.dropped > 0 and bare.aborted > 0


@pytest.mark.parametrize("load", sorted(LOADS))
def test_tracing_draws_no_random_number(monkeypatch, load):
    bare, _, _ = _virtual_run(monkeypatch, load)
    traced, _, _, records = _traced(monkeypatch, load)
    assert traced.rng.bit_generator.state == bare.rng.bit_generator.state
    assert (traced.params.alpha, traced.params.beta) == \
        (bare.params.alpha, bare.params.beta)
    # adaptivity ran, so the generator was drawn from, by both alike
    assert bare.rng.bit_generator.state != \
        np.random.default_rng(11).bit_generator.state
    windows = [r for r in records if r["kind"] == "engine.window"]
    # a window closes on a pass that dispatches nothing
    assert windows and all(r["t0"] == r["t1"] for r in windows)
    assert sum(r["attrs"]["frames"] for r in windows) <= \
        sum(1 for r in records if r["kind"] == "job")


@pytest.mark.parametrize("load", sorted(LOADS))
def test_one_job_span_a_frame_adding_up_to_the_report(monkeypatch, load):
    eng, q, report, records = _traced(monkeypatch, load)
    for rec in records:
        validate_span(rec)
    jobs = [r for r in records if r["kind"] == "job"]
    assert len(jobs) == len(q.pending)
    assert len({r["attrs"]["uid"] for r in jobs}) == len(jobs)
    by = Counter(r["attrs"]["outcome"] for r in jobs)
    assert by["dropped"] == eng.dropped == report.dropped
    assert by["aborted"] == eng.aborted
    assert by["done"] + by["dropped"] + by["aborted"] == report.frames
    assert by["done"] == sum(map(len, eng.lat_samples.values()))
    assert by["unfinished"] == sum(1 for r in q.pending if not r.done)
    served = {f"r{r.rid}": r for r in q.pending if r.done and not r.dropped}
    for rec in jobs:
        a = rec["attrs"]
        segs = _job_segments(rec)
        assert segs[0]["t0"] == rec["t0"] and segs[-1]["t1"] == rec["t1"]
        assert all(x["t1"] == y["t0"] for x, y in zip(segs, segs[1:]))
        assert a["origin"] >= rec["t0"]
        if a["outcome"] == "done":
            req = served[a["uid"]]
            assert [s["seg"] for s in segs][-1] == "exec"
            assert a["segs"][0][1] == rec["t1"]
            assert a["completion"] == req.completion
            assert a["variant"] in LAT and a["slice"] in ("big", "small")
        else:
            assert a.get("segs") is None
            assert [s["seg"] for s in segs] == ["queue"]


def test_cascade_jobs_name_their_parent_for_the_critical_path(monkeypatch):
    _, _, _, records = _traced(monkeypatch, "light")
    children = [r for r in records if r["kind"] == "job"
                and r["attrs"]["model"] == "ver"
                and r["attrs"]["outcome"] == "done"]
    assert children
    for rec in children:
        path = critical_path(records, tail_uid=rec["attrs"]["uid"])
        parent = next(r for r in records if r["kind"] == "job"
                      and r["attrs"]["uid"] == rec["attrs"]["parent"])
        assert path["chain"] == [parent["attrs"]["uid"], rec["attrs"]["uid"]]
        assert parent["attrs"]["model"] == "det"
        assert path["total_s"] == pytest.approx(rec["t1"] - parent["t0"])


@pytest.mark.parametrize("load", sorted(LOADS))
def test_one_of_each_phase_a_dispatch_tiling_the_run(monkeypatch, load):
    eng, _, _, records = _traced(monkeypatch, load)
    run = [r for r in records if r["kind"] == "engine.run"]
    assert len(run) == 1
    sid = run[0]["sid"]
    assert all(r["attrs"]["run"] == sid for r in records
               if r["kind"] != "engine.run")
    dispatches = sum(map(len, eng.lat_samples.values()))
    kinds = Counter(r["kind"] for r in records)
    for k in LOOP[1:]:
        assert kinds[k] == dispatches
    assert 0 < kinds["engine.wait"] <= dispatches + 1
    loop = sorted((r for r in records if r["kind"] in LOOP),
                  key=lambda r: (r["t0"], r["t1"]))
    assert all(a["t1"] == b["t0"] for a, b in zip(loop, loop[1:]))
    assert loop[-1]["t1"] == run[0]["t1"] >= 3.0
    decides = [r for r in loop if r["kind"] == "engine.decide"]
    assert all(r["attrs"]["evals"] == r["attrs"]["ready"]
               * r["attrs"]["idle"] >= 1 for r in decides)
    # each decide is followed by its enqueue, sync and after
    order = [r["kind"] for r in loop]
    for i, k in enumerate(order):
        if k == "engine.decide":
            assert order[i + 1:i + 4] == list(LOOP[2:])


def test_mapped_enqueue_spans_hold_the_profiler_call_regions():
    """On the real clock: each call's ``record_function`` region, as the
    CPU profiler stamps it, lies inside its ``engine.enqueue`` span mapped
    through the run's two (engine seconds, Unix ns) pairs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def fn(params, tokens):
        with record_function("call:x"):
            time.sleep(0.002)
            return tokens.float() @ params["w"]

    obs = Obs(tracer=SpanTracer())
    eng = ServingEngine([VirtualAccelerator("a", 1.0, 1.0)], obs=obs)
    eng.register(ModelHandle("x", None, {"w": torch.ones(8, 4)}, fn),
                 np.zeros((1, 8), np.int32))
    q = RequestQueue(clock=lambda: 0.0)
    q.add_stream("x", fps=100.0, batch=1, seq=8, vocab=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(q, duration_s=0.4)
    calls = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CPU
                   and ev.is_user_annotation() and ev.name() == "call:x")
    records = obs.tracer.to_records()
    (run,) = [r for r in records if r["kind"] == "engine.run"]
    (e0, u0), (e1, u1) = run["attrs"]["clock"]
    assert 0.0 <= e0 < e1 <= run["t1"] + 1e-3
    to_ns = lambda t: u0 + (t - e0) * (u1 - u0) / (e1 - e0)
    enq = [(to_ns(r["t0"]), to_ns(r["t1"])) for r in records
           if r["kind"] == "engine.enqueue"]
    assert len(enq) == len(calls) >= 20
    slack = 0.2e6
    for (cs, ce), (es, ee) in zip(calls, enq):
        assert es - slack <= cs and ce <= ee + slack


def test_an_untraced_engine_keeps_no_tracer():
    eng = ServingEngine([VirtualAccelerator("a")])
    assert eng._tracer is None
    traced = ServingEngine([VirtualAccelerator("a")],
                           obs=types.SimpleNamespace(tracer=None))
    assert traced._tracer is None
