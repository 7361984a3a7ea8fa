"""The benchmark's queue: arrivals, cascade triggers and prompts are a
function of the seed; the arithmetic of the end-to-end metrics and of the
engine's accounting on synthetic frame records."""
from __future__ import annotations

import json

import numpy as np
import pytest

from rtmmbench import traffic
from rtmmbench.harness import PKG
from rtmmbench.traffic import BenchQueue, Frame

VOCAB = {"kws": 50280, "speech": 32000, "detector": 151936,
         "verifier": 32064, "context": 151936}


def _mix(config: str) -> dict:
    return json.loads((PKG / "traffic" / "steady" / f"{config}.json")
                      .read_text())


def _drive(config: str, seed: int, seconds: float = 3.0) -> BenchQueue:
    """Poll every millisecond and trigger each frame's dependents 2 ms
    after its arrival, as an engine that serves at once would."""
    q = BenchQueue(_mix(config), VOCAB, seed, seconds)
    for step in range(int((seconds + 0.5) * 1000)):
        for f in q.poll(step / 1000):
            f.done = True
            assert q.trigger_dependents(f.model, f.arrival + 0.002) == []
    return q


def _key(q: BenchQueue) -> list:
    return [(f.model, round(f.arrival, 9), f.tokens.tobytes())
            for f in q.frames]


@pytest.mark.parametrize("config", ["rtmm_vision", "rtmm_audio"])
def test_queue_is_a_function_of_the_seed(config):
    a, b = _drive(config, 2**31 + 11), _drive(config, 2**31 + 11)
    assert _key(a) == _key(b)
    c = _drive(config, 2**31 + 12)
    assert _key(c) != _key(a)
    # each head stream's frame count agrees; a cascade stage's within the
    # spread of its independent draws
    count = lambda q: {m: sum(f.model == m for f in q.frames)
                       for m in q.streams}
    ca, cc = count(a), count(c)
    for m, s in a.streams.items():
        if s.after is None:
            assert abs(ca[m] - cc[m]) <= 2, (m, ca, cc)
        else:
            n = ca[s.after]
            sd = (n * s.trigger_prob * (1 - s.trigger_prob)) ** 0.5
            assert abs(ca[m] - cc[m]) <= 6 * sd, (m, ca, cc)


def test_arrivals_stop_at_the_window_and_follow_the_rate():
    q = _drive("rtmm_vision", 7, seconds=2.0)
    heads = [f for f in q.frames if f.depends_on is None]
    assert heads and max(f.arrival for f in heads) < 2.0
    mix = _mix("rtmm_vision")
    det = sum(f.model == "detector" for f in heads)
    assert abs(det - 2.0 * mix["streams"]["detector"]["fps"]) <= 2


def test_triggers_are_draws_held_until_their_arrival():
    mix = _mix("rtmm_audio")
    p = mix["streams"]["speech"]["trigger_prob"]
    q = BenchQueue(mix, VOCAB, 99, 10.0)
    n = 4000
    for _ in range(n):
        assert q.trigger_dependents("kws", 0.5) == []
    hits = len(q.frames)
    assert abs(hits - p * n) <= 4 * (n * p * (1 - p)) ** 0.5
    # the engine sees none before its parent's completion, all after it
    assert [f for f in q.poll(0.499) if f.depends_on] == []
    out = q.poll(0.5)
    assert len(out) == hits and all(f.arrival == 0.5 for f in out)
    assert [f for f in q.poll(0.6) if f.depends_on] == []


def test_prompts_are_uniform_over_the_vocabulary():
    q = BenchQueue(_mix("rtmm_audio"), VOCAB, 3, 1.0)
    toks = np.concatenate([q._make(q.streams["kws"], 0.0).tokens.ravel()
                           for _ in range(200)])
    assert toks.min() >= 0 and toks.max() < VOCAB["kws"]
    assert abs(toks.mean() / VOCAB["kws"] - 0.5) < 0.01


def test_frame_keeps_no_logits():
    f = Frame(0, "kws", np.zeros((1, 4), np.int32), 0.0, 0.1, None)
    f.result = object()
    assert f.result is None


def _frame(model, arrival, deadline, completion=None, dropped=False,
           served=None):
    """A record whose engine's completion is ``completion`` and whose
    logits were handed over at ``served`` (``completion`` if not given)."""
    f = Frame(0, model, np.zeros((1, 1), np.int32), arrival, deadline, None)
    f.done = completion is not None or dropped
    f.dropped, f.completion = dropped, completion
    if completion is not None and not dropped:
        f.served_s = completion if served is None else served
    return f


def test_p95_goodput_and_accounting_on_synthetic_records():
    frames = [_frame("a", 0.01 * i, 0.01 * i + 0.05, 0.01 * i + 0.001 * i)
              for i in range(100)]
    frames.append(_frame("a", 0.5, 0.55, dropped=True))      # not served
    frames.append(_frame("b", 2.0, 2.1, 2.01))               # after window
    frames.append(_frame("b", 0.2, 0.25))                    # never done
    frames[-1].done = False
    lat = [i * 1.0 for i in range(100)]                      # ms
    p95, n = traffic.frame_p95_ms(frames, 1.0)
    assert n == 100 and p95 == pytest.approx(np.percentile(lat, 95))
    # deadline 50 ms: frames 0..50 complete by it
    assert traffic.goodput_fps(frames, 1.0) == pytest.approx(51 / 1.0)
    acct = traffic.accounting(frames)
    assert acct == {"a": {"frames": 101, "violated": 50},
                    "b": {"frames": 1, "violated": 0}}


def test_latency_is_the_hand_over_on_the_engine_clock(monkeypatch):
    """The hand-over is read on the host clock as the engine sets a frame's
    result, and put on the engine's clock by the polls' origin; the
    engine's modelled completion does not enter the metrics."""
    clock = iter([100.0, 100.2, 100.3, 100.45])
    monkeypatch.setattr(traffic.time, "perf_counter", lambda: next(clock))
    q = BenchQueue(_mix("rtmm_audio"), VOCAB, 5, 1.0)
    q.poll(0.0)                    # origin 100.0
    q.poll(0.15)                   # 100.2 - 0.15 > 100.0: origin kept
    f = q._make(q.streams["kws"], 0.25)   # deadline 0.35
    f.result = object()            # handed at 100.3: 0.3 on the engine clock
    f.done, f.completion = True, 0.45     # the engine's, after its deadline
    q.close()
    assert q.origin == 100.0 and f.served_s == pytest.approx(0.3)
    p95, n = traffic.frame_p95_ms([f], 1.0)
    assert n == 1 and p95 == pytest.approx(50.0)
    assert f.met and traffic.goodput_fps([f], 1.0) == 1.0
    assert f.violated               # the engine's own verdict, for its report
