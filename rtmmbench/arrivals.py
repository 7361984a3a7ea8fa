"""Arrival processes of request streams: a frozen copy of the port's
``repro_torch/scenarios/arrivals.py``, kept here so that the traffic the
benchmark offers cannot change with the program under test.

Real deployments see jittery sensors, event-driven triggers (Poisson),
bursty on/off traffic (voice activity, MMPP-style) and slow diurnal load
swings. Each process implements the protocol the request queue consumes:

    start(index, period_s, rng) -> float | None
        Reset internal state and return the absolute time of the first
        arrival (None = the stream never fires). ``index`` is the stream's
        position, used only for deterministic phase offsets.

    next_after(t, period_s, rng) -> float | None
        The next arrival strictly after an arrival at ``t``. ``period_s``
        is passed on every call, so a retargeted FPS takes effect from the
        next inter-arrival interval onward.

All stochastic draws come from the ``rng`` handed in by the caller, as the
same numpy ``Generator`` calls in the same order as the JAX package's, so a
stream's arrival times equal the reference's bit for bit. Every process
serializes to a plain dict via ``to_config`` and back via
``arrival_from_config``.

One process instance drives exactly one stream: ``start`` resets any
internal state, but two streams must not share an instance within a run.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

_PROCESS_KINDS: dict[str, type] = {}


def _register(cls: type) -> type:
    _PROCESS_KINDS[cls.kind] = cls
    return cls


class ArrivalProcess:
    """Base class: deterministic-phase periodic behaviour by default."""

    kind = "abstract"

    def start(self, index: int, period_s: float, rng) -> Optional[float]:
        raise NotImplementedError

    def next_after(self, t: float, period_s: float, rng) -> Optional[float]:
        raise NotImplementedError

    def to_config(self) -> dict:
        cfg = {"kind": self.kind}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            if not f.name.startswith("_"):
                cfg[f.name] = getattr(self, f.name)
        return cfg


def legacy_phase(index: int, period_s: float) -> float:
    """The JAX package's simulator's deterministic de-synchronizing phase
    offset."""
    return period_s * ((index * 7919) % 97) / 97.0


@_register
@dataclass
class Periodic(ArrivalProcess):
    """Strictly periodic frames — byte-compatible with the legacy engine.

    ``phase_frac`` pins the first arrival at ``phase_frac * period``; the
    default None reproduces the legacy index-hashed phase, so scenarios
    without an explicit arrival process keep their historical schedules.
    """

    kind = "periodic"
    phase_frac: Optional[float] = None

    def start(self, index, period_s, rng):
        if self.phase_frac is None:
            return legacy_phase(index, period_s)
        return self.phase_frac * period_s

    def next_after(self, t, period_s, rng):
        return t + period_s


@_register
@dataclass
class PeriodicJitter(ArrivalProcess):
    """Periodic with per-frame uniform jitter of +/- ``jitter`` * period.

    Intervals are floored at 5% of the period so the stream can never
    collapse into a zero-time burst.
    """

    kind = "periodic_jitter"
    jitter: float = 0.1

    def start(self, index, period_s, rng):
        return float(rng.uniform(0.0, period_s))

    def next_after(self, t, period_s, rng):
        dt = period_s * (1.0 + self.jitter * float(rng.uniform(-1.0, 1.0)))
        return t + max(dt, 0.05 * period_s)


@_register
@dataclass
class Poisson(ArrivalProcess):
    """Memoryless arrivals with mean inter-arrival time = the period.

    ``rate_scale`` multiplies the nominal 1/period rate (e.g. 2.0 doubles
    the offered load without touching the deadline-defining FPS target).
    """

    kind = "poisson"
    rate_scale: float = 1.0

    def _gap(self, period_s, rng):
        return float(rng.exponential(period_s / self.rate_scale))

    def start(self, index, period_s, rng):
        return self._gap(period_s, rng)

    def next_after(self, t, period_s, rng):
        return t + self._gap(period_s, rng)


@_register
@dataclass
class BurstyOnOff(ArrivalProcess):
    """Two-state MMPP: Poisson bursts at ``burst_factor``/period while ON,
    silence while OFF.  State holding times are exponential with means
    ``on_s`` / ``off_s``.  Mean rate ~ (on/(on+off)) * burst_factor / period,
    so the defaults roughly preserve the nominal FPS while clustering it.
    """

    kind = "bursty"
    on_s: float = 0.5
    off_s: float = 0.5
    burst_factor: float = 2.0

    def __post_init__(self):
        self._on = True
        self._switch_t = 0.0

    def start(self, index, period_s, rng):
        self._on = bool(rng.random() < self.on_s / (self.on_s + self.off_s))
        hold = self.on_s if self._on else self.off_s
        self._switch_t = float(rng.exponential(hold))
        return self.next_after(0.0, period_s, rng)

    def next_after(self, t, period_s, rng):
        cur = t
        for _ in range(10_000):  # bounded walk; rates are all finite
            if self._on:
                gap = float(rng.exponential(period_s / self.burst_factor))
                if cur + gap <= self._switch_t:
                    return cur + gap
                cur = self._switch_t
                self._on = False
                self._switch_t = cur + float(rng.exponential(self.off_s))
            else:
                cur = self._switch_t
                self._on = True
                self._switch_t = cur + float(rng.exponential(self.on_s))
        return None  # pragma: no cover — degenerate parameters


@_register
@dataclass
class Diurnal(ArrivalProcess):
    """Non-homogeneous Poisson with a sinusoidal rate: thinning against
    rate(t) = (1 + amplitude * sin(2*pi*(t/day_s + phase))) / period.

    ``day_s`` is the full load cycle (compressed to seconds for simulation);
    amplitude in [0, 1).  Models millions-of-users scale diurnal traffic.
    """

    kind = "diurnal"
    amplitude: float = 0.8
    day_s: float = 8.0
    phase: float = 0.0

    def _rate(self, t: float, period_s: float) -> float:
        s = math.sin(2.0 * math.pi * (t / self.day_s + self.phase))
        return (1.0 + self.amplitude * s) / period_s

    def next_after(self, t, period_s, rng):
        rate_max = (1.0 + self.amplitude) / period_s
        cur = t
        for _ in range(100_000):
            cur += float(rng.exponential(1.0 / rate_max))
            if float(rng.random()) * rate_max <= self._rate(cur, period_s):
                return cur
        return None  # pragma: no cover

    def start(self, index, period_s, rng):
        return self.next_after(0.0, period_s, rng)


@_register
@dataclass
class Triggered(ArrivalProcess):
    """No autonomous arrivals: frames come only from an external driver.

    The JAX package's fleet layer uses it for cascade stages split away from
    their head (frames are injected when cross-node triggers land); a
    request-queue stream with it never emits a frame. ``start`` and
    ``next_after`` always return None and consume no randomness.
    """

    kind = "triggered"

    def start(self, index, period_s, rng):
        return None

    def next_after(self, t, period_s, rng):
        return None


def arrival_from_config(cfg: dict) -> ArrivalProcess:
    """Materialize a process from its ``to_config`` dict."""
    d = dict(cfg)
    kind = d.pop("kind")
    try:
        cls = _PROCESS_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown arrival process kind: {kind!r}") from None
    return cls(**d)


def arrival_kinds() -> tuple[str, ...]:
    return tuple(sorted(_PROCESS_KINDS))
