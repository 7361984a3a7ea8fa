"""The serving engine's own spans on the profiler's clock: what the engine
layer's readers read.

Given an ``Obs`` with a ``SpanTracer``, ``ServingEngine.run`` records, on
its own clock (seconds since the run's start), one ``job`` span per frame
(arrival, dispatch, hand-over or drop) and the loop's phases as flat spans
(``engine.wait``, ``engine.decide``, ``engine.enqueue``, ``engine.sync``,
``engine.after``), each tagged with the run's ``engine.run`` span. That
span holds two (engine seconds, Unix ns) pairs, read back to back at the
run's start and end, and ``torch.profiler`` stamps its events in Unix ns:
the two pairs map the run's spans linearly onto the device trace.
``EngineSpans.read`` does that, and keeps what lies in the traced window.

A frame's queue segment runs from its arrival to its dispatch (to its
drop, abandonment or the run's end where it was not dispatched). Device
idle time inside the union of those segments is capacity lost while work
waited; idle time outside it is offered load.
"""
from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .trace import Timeline

#: the loop's interval spans, which follow one another without overlap
LOOP = ("engine.wait", "engine.decide", "engine.enqueue", "engine.sync",
        "engine.after")

Intervals = list[tuple[int, int]]


def unix_ns(run: dict) -> Callable[[float], int]:
    """The map from the engine's clock (s) to Unix ns of an ``engine.run``
    span, through its two clock pairs."""
    (e0, u0), (e1, u1) = run["attrs"]["clock"]
    rate = (u1 - u0) / (e1 - e0) if e1 > e0 else 1e9
    return lambda t: u0 + int(round((t - e0) * rate))


def union(intervals: Intervals) -> Intervals:
    """Sorted, disjoint intervals covering the same time."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a: Intervals, b: Intervals) -> int:
    """The time two lists of sorted, disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clip(s: int, e: int, lo: int, hi: int) -> Optional[tuple[int, int]]:
    s, e = max(s, lo), min(e, hi)
    return (s, e) if e > s else None


@dataclass
class EngineSpans:
    """One engine run's spans on the profiler's clock, against the traced
    window of ``timeline``."""

    timeline: Timeline
    #: the loop's spans (start_ns, end_ns, kind), clipped to the window
    loop: list[tuple[int, int, str]]
    #: the union of the frames' queue segments, clipped to the window
    waiting: Intervals
    #: dispatch minus arrival (ms) of each frame dispatched in the window
    queue_ms: list[float]
    #: ``evals`` of each ``engine.decide`` that starts in the window
    evals: list[int]
    #: the ``engine.enqueue`` spans, whole, that overlap the window
    enqueue: Intervals
    #: the attributes of the ``engine.window`` events in the window
    windows: list[dict]
    #: every job span of the run by its ``outcome``
    outcomes: Counter

    @classmethod
    def read(cls, records: list[dict], timeline: Timeline
             ) -> Optional["EngineSpans"]:
        """The last engine run among ``records`` (None if there is none)
        against ``timeline``'s window."""
        runs = [r for r in records if r["kind"] == "engine.run"]
        if not runs:
            return None
        run = max(runs, key=lambda r: r["sid"])
        to_ns = unix_ns(run)
        lo, hi = timeline.window()
        loop, waiting, queue_ms, evals, enqueue, windows = ([] for _ in
                                                            range(6))
        outcomes: Counter = Counter()
        for rec in records:
            a = rec["attrs"]
            if a.get("run") != run["sid"]:
                continue
            kind = rec["kind"]
            s, e = to_ns(rec["t0"]), to_ns(rec["t1"])
            if kind == "job":
                outcomes[a["outcome"]] += 1
                segs = a.get("segs") or []
                arrival = to_ns(a["origin"])
                end = to_ns(segs[0][0]) if segs else e
                seg = _clip(arrival, end, lo, hi)
                if seg is not None:
                    waiting.append(seg)
                if segs and lo <= end < hi:
                    queue_ms.append((segs[0][0] - a["origin"]) * 1e3)
            elif kind == "engine.window":
                if lo <= s < hi:
                    windows.append(a)
            elif kind in LOOP:
                if kind == "engine.decide" and lo <= s < hi:
                    evals.append(a["evals"])
                if kind == "engine.enqueue" and e > lo and s < hi:
                    enqueue.append((s, e))
                seg = _clip(s, e, lo, hi)
                if seg is not None:
                    loop.append((*seg, kind))
        return cls(timeline, sorted(loop), union(waiting), queue_ms, evals,
                   sorted(enqueue), windows, outcomes)

    # ------------------------------------------------------------ metrics
    def window_ns(self) -> int:
        lo, hi = self.timeline.window()
        return hi - lo

    def idle(self) -> Intervals:
        """The window's device idle gaps."""
        lo, hi = self.timeline.window()
        out, t = [], lo
        for s, e in self.timeline.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def ready_idle_share(self) -> float:
        """% of the window in which the device idles while a frame waits."""
        return 100.0 * overlap_ns(self.waiting, self.idle()) \
            / self.window_ns()

    def queue_wait_p95_ms(self) -> Optional[float]:
        if not self.queue_ms:
            return None
        return float(np.percentile(self.queue_ms, 95))

    def engine_us_per_dispatch(self) -> Optional[float]:
        """The engine's own time around each call, ``engine.decide`` and
        ``engine.after``, per dispatch in the window, in us."""
        if not self.evals:
            return None
        own = sum(e - s for s, e, k in self.loop
                  if k in ("engine.decide", "engine.after"))
        return own / 1e3 / len(self.evals)

    # ------------------------------------------------------- the log line
    def by_kind_s(self) -> dict[str, float]:
        """Seconds of the window in each loop span kind, ``engine.wait``
        split into the part with a frame waiting (``engine.wait.ready``)
        and the rest (``engine.wait.empty``)."""
        out: dict[str, float] = {}
        for s, e, k in self.loop:
            out[k] = out.get(k, 0.0) + (e - s) / 1e9
        waits = [(s, e) for s, e, k in self.loop if k == "engine.wait"]
        ready = overlap_ns(waits, self.waiting) / 1e9
        out["engine.wait.ready"] = ready
        out["engine.wait.empty"] = out.get("engine.wait", 0.0) - ready
        return out

    def call_offsets_ns(self) -> list[tuple[int, int]]:
        """For each ``call:<model>`` region of the window, (its start minus
        its ``engine.enqueue`` span's start, that span's end minus its end):
        both at least 0 where the mapped span contains the region. A
        region's span is the one it overlaps most."""
        starts = [s for s, _ in self.enqueue]
        out = []
        for s, e, name in self.timeline.host:
            if not name.startswith("call:") or not self.enqueue:
                continue
            j = bisect.bisect_right(starts, s)
            near = [self.enqueue[i] for i in (j - 1, j)
                    if 0 <= i < len(self.enqueue)]
            es, ee = max(near, key=lambda q: min(q[1], e) - max(q[0], s))
            out.append((s - es, ee - e))
        return out

    def summary(self) -> str:
        kinds = ", ".join(f"{k} {v:.4f}" for k, v in
                          sorted(self.by_kind_s().items()))
        parts = [f"engine spans in the window (s): {kinds}"]
        if self.evals:
            parts.append(f"MapScore evaluations per dispatch "
                         f"{np.mean(self.evals):.3f} over "
                         f"{len(self.evals)} dispatches")
        if self.queue_ms:
            parts.append(f"queue wait ms median "
                         f"{np.median(self.queue_ms):.3f} p95 "
                         f"{np.percentile(self.queue_ms, 95):.3f} over "
                         f"{len(self.queue_ms)} frames")
        if self.windows:
            al = [w["alpha"] for w in self.windows]
            be = [w["beta"] for w in self.windows]
            parts.append(f"alpha {min(al):.4f}-{max(al):.4f}, beta "
                         f"{min(be):.4f}-{max(be):.4f} over "
                         f"{len(self.windows)} windows")
        off = self.call_offsets_ns()
        if off:
            st = [a for a, _ in off]
            en = [b for _, b in off]
            parts.append(f"call regions in their engine.enqueue spans: "
                         f"start offset us median {np.median(st) / 1e3:.3f} "
                         f"min {min(st) / 1e3:.3f} max {max(st) / 1e3:.3f}; "
                         f"end offset us median {np.median(en) / 1e3:.3f} "
                         f"min {min(en) / 1e3:.3f} max {max(en) / 1e3:.3f} "
                         f"over {len(off)} calls")
        return "; ".join(parts)
