"""The traced run's reading: ``torch.profiler`` over the last ``TRACE_S``
seconds of the arrivals, the harness's own host regions in it, and the
reduction of the trace to device busy time, kernel time by name, idle gaps
and the device's top operations.

The traced window is a part of the run, not all of it: over a whole 51 s
window the profiler's records (some 400 kernels a call) took the traced
run past 350 s and slowed its serving. It ends with the arrivals, so that
the drain's idle tail is not in it, and starts ``TRACE_S`` before; a
profile in set-up has made the profiler's first, slow start.

Host regions are ``torch.profiler.record_function`` ranges the harness
opens around what it owns: each model call (``call:<model>``), the queue's
``poll`` and ``trigger_dependents``, and the instants ``window_start`` and
``window_end`` that bound the traced window. An idle gap of the device is charged to the regions that
overlap it, and what no region covers to ``engine`` (the serving engine's
own loop: MapScore, drops, adaptivity, its sleep and its wait on the
stream).
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

#: seconds of the run the profiler records
TRACE_S = 10.0


class Tracer:
    """Host regions for the profiler, and the profiler itself, started by
    ``clock`` (the queue's, called at every poll) at ``seconds - TRACE_S``
    and read by ``finish``; ``calls`` snapshots the calls made so far at
    the traced window's start and end. No-ops when off."""

    def __init__(self, on: bool, seconds: float = 0.0,
                 calls: Callable[[], dict] = dict):
        self.on, self.seconds, self.calls = on, seconds, calls
        self.start_at = max(0.0, seconds - TRACE_S)
        self.prof = None
        self.at: dict[str, dict] = {}

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def mark(self, name: str) -> None:
        with torch.profiler.record_function(name):
            pass
        self.at[name] = self.calls()

    def warm(self, fn: Callable[[], None]) -> None:
        """One profile of ``fn`` in set-up: the profiler's first start in a
        process is its slowest."""
        if self.on:
            with profiler():
                fn()

    def clock(self, now: float) -> None:
        if not self.on:
            return
        if self.prof is None and now >= self.start_at:
            self.prof = profiler()
            self.prof.start()
            self.mark("window_start")
        elif "window_end" not in self.at and now >= self.seconds:
            self.mark("window_end")

    def finish(self) -> Optional["Timeline"]:
        """Stop the profiler and read the traced window (None if off)."""
        if self.prof is None:
            return None
        if "window_end" not in self.at:
            self.mark("window_end")
        self.prof.stop()
        timeline = read(self.prof)
        self.prof = None
        return timeline


def profiler():
    """A profiler of host and device activity (not started)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class Timeline:
    """Device operations and host regions of the traced window as
    (start_ns, end_ns, name), clipped to it and sorted by start; ``marks``
    the instants by name."""

    device: list[tuple[int, int, str]]
    host: list[tuple[int, int, str]]
    marks: dict[str, int] = field(default_factory=dict)

    def window(self) -> tuple[int, int]:
        """The traced window: from ``window_start`` to ``window_end``."""
        return self.marks["window_start"], self.marks["window_end"]

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals."""
        out: list[list[int]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_s(self, names: tuple[str, ...]) -> float:
        """Summed time of the device operations named by any of ``names``
        (whole words of the profiler's name: a kernel's function name)."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(e - s for s, e, n in self.device if pat.search(n)) / 1e9

    def top_ops(self, k: int = 10, width: int = 160) -> list[list]:
        """The ``k`` device operations that took most time, by name (cut to
        ``width`` characters: a template kernel's name runs to thousands)."""
        by = defaultdict(int)
        for s, e, n in self.device:
            by[n] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:width], ns / 1e9] for n, ns in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle device time in the window by what the host was doing: each
        gap's overlap with each host region (``call:<model>`` regions
        counted under their name), the rest under "engine"; the ``k``
        regions with most idle time."""
        lo, hi = self.window()
        gaps, t = [], lo
        busy = self.busy()
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        regions = self.host
        starts = [h[0] for h in regions]
        by = defaultdict(int)
        for gs, ge in gaps:
            covered = 0
            # the regions follow one another without nesting, so their ends
            # rise with their starts: walk back from the last that starts
            # before the gap ends to the first that ends before it starts
            j = bisect.bisect_right(starts, ge) - 1
            while j >= 0 and regions[j][1] > gs:
                hs, he, name = regions[j]
                ov = min(ge, he) - max(gs, hs)
                by[name] += ov
                covered += ov
                j -= 1
            by["engine"] += max(ge - gs - covered, 0)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]


def read(prof) -> Timeline:
    """The profiler's events as a ``Timeline`` clipped to the traced window
    (``window_start`` to ``window_end``): device kernels, copies and sets
    (not the profiler's own annotation ranges), and the host's
    ``record_function`` regions."""
    from torch.autograd import DeviceType
    device, host, marks = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((s, e, ev.name()))
        elif ev.is_user_annotation():
            name = ev.name()
            if name.startswith("window_"):
                marks[name] = s
            else:
                host.append((s, e, name))
    lo, hi = marks["window_start"], marks["window_end"]
    clip = lambda evs: sorted((max(s, lo), min(e, hi), n) for s, e, n in evs
                              if e > lo and s < hi)
    return Timeline(clip(device), clip(host), marks)
