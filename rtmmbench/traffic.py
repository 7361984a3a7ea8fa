"""The benchmark's frame traffic: one general generator over a traffic file.

A traffic file (``traffic/<mix>/<config>.json``) names, per stream, either
a head stream (``fps``, drawn by the file's ``arrival`` process from the
frozen ``arrivals`` copy) or a cascade stage (``after`` a parent stream,
``trigger_prob``), with each stream's frame length ``seq`` and its deadline
in milliseconds; ``drain_s`` is how long the engine runs on after the last
arrival. Everything random comes from ``--seed``:

* each head stream's arrivals, from a generator of its own;
* each cascade stage's triggers: one draw with ``trigger_prob`` per
  served parent frame, from a generator of the stage's own;
* each frame's prompt, uniform over its model's vocabulary.

``BenchQueue`` offers the engine's queue interface (``poll``,
``trigger_dependents``), stops head arrivals at the window's end, and keeps
every frame's record, without its logits (``Frame``). A cascade frame
arrives when the engine says its parent completed; the queue holds it
back and hands it out from ``poll`` once the clock has reached that time.

A frame's latency is the benchmark's own reading of the host clock: from
its arrival to the moment the engine hands it its logits, after the
call's wait on the stream (``Frame.handed``), on the engine's clock
(``BenchQueue.close``). The engine's ``completion``, which on a slower
slice is modelled (dispatch plus the calibrated latency over the slice's
speed), is kept for its accounting only.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from .arrivals import arrival_from_config


class Frame:
    """One frame's record, read by the engine as its ``ServeRequest``: the
    logits the engine hands it (``result``) are not kept, so that the
    device's memory does not grow with the window's frames; the host clock
    is read as they are handed (``handed``, ``time.perf_counter``), and
    ``served_s`` is that moment on the engine's clock."""

    __slots__ = ("rid", "model", "tokens", "arrival", "deadline",
                 "depends_on", "done", "dropped", "completion", "energy",
                 "handed", "served_s")

    def __init__(self, rid: int, model: str, tokens: np.ndarray,
                 arrival: float, deadline: float,
                 depends_on: Optional[str]):
        self.rid, self.model, self.tokens = rid, model, tokens
        self.arrival, self.deadline = arrival, deadline
        self.depends_on = depends_on
        self.done = self.dropped = False
        self.completion: Optional[float] = None
        self.energy = 0.0
        self.handed: Optional[float] = None
        self.served_s: Optional[float] = None

    @property
    def result(self) -> None:
        return None

    @result.setter
    def result(self, _: Any) -> None:
        self.handed = time.perf_counter()

    @property
    def violated(self) -> bool:
        return self.dropped or (self.completion is not None
                                and self.completion > self.deadline)

    @property
    def served(self) -> bool:
        return self.done and not self.dropped and self.served_s is not None

    @property
    def met(self) -> bool:
        """Served by its deadline, on the benchmark's clock."""
        return self.served and self.served_s <= self.deadline


@dataclass
class _Stream:
    name: str
    seq: int
    vocab: int
    deadline_s: float
    tokens_rng: np.random.Generator
    fps: Optional[float] = None
    after: Optional[str] = None
    trigger_prob: float = 0.0
    arrival: Any = None
    rng: Optional[np.random.Generator] = None
    next_t: Optional[float] = None


class BenchQueue:
    """Frames of ``traffic`` (a traffic file's dict, its head rates scaled
    by ``rate_factor``) for the models' vocabularies ``vocab``, from
    ``seed``, with head arrivals before ``seconds`` only.

    ``span(name)`` wraps ``poll`` and ``trigger_dependents`` (a tracer's
    host region; a no-op by default) and ``clock(now)`` is called at each
    poll (a tracer's timer). ``waiting`` holds the mean number of frames
    arrived and not yet done over the polls of the window's middle tenth
    ("mid") and of its last tenth ("end"). ``origin`` is the host clock's
    reading at the engine's time 0: the least of ``perf_counter() - now``
    over the polls, each read just after the engine's own.
    """

    #: the window's bands over which ``waiting`` is averaged
    BANDS = {"mid": (0.45, 0.55), "end": (0.9, 1.0)}

    def __init__(self, traffic: dict, vocab: dict[str, int], seed: int,
                 seconds: float, rate_factor: float = 1.0,
                 span: Callable[[str], Any] = contextlib.nullcontext,
                 clock: Callable[[float], None] = lambda now: None):
        self.seconds = seconds
        self.origin = float("inf")
        self.frames: list[Frame] = []
        self._held: list[Frame] = []
        self.waiting: dict[str, float] = {}
        self._open: list[Frame] = []
        self._band: dict[str, list[int]] = {k: [0, 0] for k in self.BANDS}
        self.span, self.clock = span, clock
        self._rid = itertools.count()
        self.streams: dict[str, _Stream] = {}
        for i, (name, st) in enumerate(traffic["streams"].items()):
            s = _Stream(name=name, seq=int(st["seq"]), vocab=vocab[name],
                        deadline_s=st["deadline_ms"] / 1e3,
                        tokens_rng=np.random.default_rng([seed, i, 1]))
            if "after" in st:
                s.after = st["after"]
                s.trigger_prob = float(st["trigger_prob"])
                s.rng = np.random.default_rng([seed, i, 2])
            else:
                s.fps = float(st["fps"]) * rate_factor
                s.rng = np.random.default_rng([seed, i, 0])
                s.arrival = arrival_from_config(traffic["arrival"])
                s.next_t = s.arrival.start(i, 1.0 / s.fps, s.rng)
            self.streams[name] = s

    # ------------------------------------------------------------ the engine's
    def poll(self, now: float) -> list[Frame]:
        with self.span("poll"):
            self.origin = min(self.origin, time.perf_counter() - now)
            self.clock(now)
            out = [f for f in self._held if f.arrival <= now]
            if out:
                self._held = [f for f in self._held if f.arrival > now]
                self._open.extend(out)
            self._bands(now)
            for s in self.streams.values():
                if s.after is not None:
                    continue
                while s.next_t is not None and s.next_t <= now \
                        and s.next_t < self.seconds:
                    out.append(self._make(s, s.next_t))
                    s.next_t = s.arrival.next_after(s.next_t, 1.0 / s.fps,
                                                    s.rng)
            return out

    def trigger_dependents(self, parent: str, now: float) -> list[Frame]:
        """Draw the cascade frames of a served ``parent`` frame, arriving
        at ``now`` (the engine's completion of the parent); they are handed
        out by ``poll``."""
        with self.span("trigger_dependents"):
            self._held.extend(
                self._make(s, now, open_=False)
                for s in self.streams.values()
                if s.after == parent and s.rng.random() < s.trigger_prob)
            return []

    def close(self) -> None:
        """Put each served frame's hand-over on the engine's clock."""
        for f in self.frames:
            if f.handed is not None:
                f.served_s = f.handed - self.origin

    # ---------------------------------------------------------------- helpers
    def _bands(self, now: float) -> None:
        for band, (lo, hi) in self.BANDS.items():
            if lo * self.seconds <= now < hi * self.seconds:
                self._open = [f for f in self._open if not f.done]
                acc = self._band[band]
                acc[0] += len(self._open)
                acc[1] += 1
                self.waiting[band] = acc[0] / acc[1]

    def _make(self, s: _Stream, t: float, open_: bool = True) -> Frame:
        tokens = s.tokens_rng.integers(0, s.vocab, size=(1, s.seq),
                                       dtype=np.int32)
        f = Frame(next(self._rid), s.name, tokens, t, t + s.deadline_s,
                  s.after)
        self.frames.append(f)
        if open_:
            self._open.append(f)
        return f


def window_frames(frames: list[Frame], seconds: float) -> list[Frame]:
    """The frames that arrived inside the window."""
    return [f for f in frames if f.arrival < seconds]


def frame_p95_ms(frames: list[Frame], seconds: float) -> tuple[float, int]:
    """(the 95th percentile of the latency, in ms, over the frames that
    arrived in the window and were served; their count)."""
    lat = [(f.served_s - f.arrival) * 1e3
           for f in window_frames(frames, seconds) if f.served]
    if not lat:
        return float("nan"), 0
    return float(np.percentile(lat, 95)), len(lat)


def goodput_fps(frames: list[Frame], seconds: float) -> float:
    """Frames that arrived in the window and were served by their deadline,
    per second of window."""
    return sum(1 for f in window_frames(frames, seconds) if f.met) / seconds


def accounting(frames: list[Frame]) -> dict[str, dict[str, int]]:
    """Frames finished and violated per stream, from the records: what the
    engine's report counts."""
    out: dict[str, dict[str, int]] = {}
    for f in frames:
        if not f.done:
            continue
        st = out.setdefault(f.model, {"frames": 0, "violated": 0})
        st["frames"] += 1
        st["violated"] += int(f.violated)
    return out
