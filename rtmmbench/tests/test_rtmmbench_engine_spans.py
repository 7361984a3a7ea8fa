"""The engine's spans on the profiler's clock (``spans.EngineSpans``) and
the engine layer's readers, on a synthetic timeline and span records."""
from __future__ import annotations

import pytest

from rtmmbench import harness, spans
from rtmmbench.harness import RunData
from rtmmbench.trace import Timeline

MS = 1_000_000                          # ns
#: a Unix time in ns, at which a float would lose some 200 ns
UNIX = 1_792_340_980_853_693_405
ENGINE = ("ready_idle_share", "queue_wait_p95_ms", "engine_us_per_dispatch")


def _timeline() -> Timeline:
    # a 100 ms window, busy 11-16 and 52-62 ms; two calls
    device = [(UNIX + 11 * MS, UNIX + 16 * MS, "k"),
              (UNIX + 52 * MS, UNIX + 62 * MS, "k")]
    host = [(UNIX + 10_200_000, UNIX + 14_800_000, "call:m"),
            (UNIX + 50_100_000, UNIX + 59_900_000, "call:m"),
            (UNIX + 30 * MS, UNIX + 31 * MS, "poll")]
    return Timeline(device, sorted(host), {"window_start": UNIX,
                                           "window_end": UNIX + 100 * MS})


def _records(run: int = 0) -> list[dict]:
    """An engine run whose clock starts 1 s before the window's start:
    frames A (arrives 5 ms, dispatched 10, handed 20), B (arrives 30,
    dropped 45) and C (arrives 48, dispatched 50, handed 70), and the
    loop's spans around the two dispatches (ms of the window)."""
    t = lambda ms: 1.0 + ms / 1e3
    recs = [{"sid": run, "kind": "engine.run", "t0": 0.0, "t1": t(100),
             "attrs": {"node": None,
                       "clock": [[0.5, UNIX - 500 * MS], [t(100),
                                                          UNIX + 100 * MS]]}}]
    tags = {"run": run, "node": None}
    sid = iter(range(run + 1, run + 100))

    def rec(kind, a, b, **attrs):
        recs.append({"sid": next(sid), "kind": kind, "t0": t(a), "t1": t(b),
                     "attrs": {**attrs, **tags}})
    rec("job", 5, 20, origin=t(5), outcome="done", segs=[[t(10), t(20)]])
    rec("job", 30, 45, origin=t(30), outcome="dropped")
    rec("job", 48, 70, origin=t(48), outcome="done", segs=[[t(50), t(70)]])
    loop = [("engine.wait", 0, 9.5), ("engine.decide", 9.5, 10),
            ("engine.enqueue", 10, 15), ("engine.sync", 15, 20),
            ("engine.after", 20, 20.4), ("engine.wait", 20.4, 49.8),
            ("engine.decide", 49.8, 50), ("engine.enqueue", 50, 60),
            ("engine.sync", 60, 70), ("engine.after", 70, 70.6),
            ("engine.wait", 70.6, 100)]
    for kind, a, b in loop:
        extra = {"evals": 2 if a < 40 else 3} if kind == "engine.decide" \
            else {}
        rec(kind, a, b, **extra)
    rec("engine.window", 40, 40, alpha=1.0, beta=0.9, uxcost=0.1, frames=1,
        violated=0)
    return recs


def _run(with_spans: bool = True) -> RunData:
    run = RunData(_timeline(), {}, {}, {}, {}, 2, {})
    if with_spans:
        run.spans = spans.EngineSpans.read(_records(), run.timeline)
    return run


def test_spans_map_onto_the_profiler_clock_exactly():
    sp = _run().spans
    assert sp.waiting == [(UNIX + 5 * MS, UNIX + 10 * MS),
                          (UNIX + 30 * MS, UNIX + 45 * MS),
                          (UNIX + 48 * MS, UNIX + 50 * MS)]
    assert sp.enqueue == [(UNIX + 10 * MS, UNIX + 15 * MS),
                          (UNIX + 50 * MS, UNIX + 60 * MS)]
    assert sp.outcomes == {"done": 2, "dropped": 1}
    assert sp.evals == [2, 3] and len(sp.windows) == 1
    assert sp.call_offsets_ns() == [(200_000, 200_000), (100_000, 100_000)]
    kinds = sp.by_kind_s()
    assert kinds["engine.wait"] == pytest.approx(0.0683)
    assert kinds["engine.wait.ready"] == pytest.approx(0.0213)
    assert "MapScore evaluations per dispatch 2.500" in sp.summary()


def test_engine_readers():
    run = _run()
    read = lambda name: harness.reader(name)(run)
    # waiting 5-10, 30-45, 48-50 ms, all while the device idles
    assert read("ready_idle_share") == pytest.approx(22.0)
    assert read("queue_wait_p95_ms") == pytest.approx(2 + 0.95 * 3)
    assert read("engine_us_per_dispatch") == pytest.approx(850.0)


def test_engine_readers_read_nothing_without_spans():
    """A run whose ``RunData`` has no ``spans`` (a harness that gives the
    engine no tracer), or whose spans are None."""
    runs = [_run(with_spans=False), _run(with_spans=False)]
    runs[1].spans = None
    for run in runs:
        for name in ENGINE:
            assert harness.reader(name)(run) is None


def test_only_the_last_runs_spans_are_read():
    tl = _timeline()
    other = [{**r, "t0": r["t0"] + 0.05, "t1": r["t1"] + 0.05}
             for r in _records(run=0) if r["kind"] != "engine.run"]
    recs = other + _records(run=200)
    sp = spans.EngineSpans.read(recs, tl)
    assert sp.outcomes == {"done": 2, "dropped": 1}
    assert spans.EngineSpans.read([], tl) is None
