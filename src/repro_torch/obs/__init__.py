"""Observability subsystem: structured tracing, metrics, hot-path profiling
(copy of ``repro/obs``, which the port may not import; its exports are
byte-equal to the reference's for the same calls).

One :class:`Obs` bundle travels through the stack — the fleet server
(``repro_torch.launch.serve_fleet --obs DIR``) makes one, and in the JAX
package the fleet simulator takes ``obs=True``:

  * :class:`~repro_torch.obs.spans.SpanTracer` — deterministic span-based
    tracing of jobs, placements, admissions, transfers (JSONL export,
    critical-path extraction via :func:`~repro_torch.obs.spans.critical_path`);
  * :class:`~repro_torch.obs.metrics.MetricsRegistry` — labeled counters /
    gauges / histograms published by the fleet, admission controller,
    contended links and tuner (Prometheus text + JSON snapshot export);
  * :class:`~repro_torch.obs.profiler.HotLoopProfiler` — per-event-kind
    wall-time accounting on the simulator hot loop.

The contract every hook honors: **off costs nothing, on changes
nothing**.  Disabled observability adds only ``is not None`` checks on
attributes that are ``None``; enabled observability consumes no RNG and
feeds no value back into any decision path, so traced/metered runs are
bit-identical to bare ones in UXCost and placements.  Both halves are
asserted for the reference by ``tests/test_obs.py``;
``tests/test_torch_obs.py`` holds this copy's exports to the reference's.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Union

from .metrics import (Counter, Gauge, Histogram, MetricsError,
                      MetricsRegistry, parse_prometheus)
from .profiler import HotLoopProfiler
from .spans import (SpanError, SpanTracer, critical_path, load_jsonl,
                    pipeline_tails, validate_span)

__all__ = [
    "Obs", "SpanTracer", "MetricsRegistry", "HotLoopProfiler",
    "Counter", "Gauge", "Histogram",
    "critical_path", "pipeline_tails", "validate_span", "load_jsonl",
    "parse_prometheus", "SpanError", "MetricsError",
]


class Obs:
    """Bundle of the three observability facilities, each optional.

    Attributes are ``None`` when the facility is off — instrumented call
    sites guard on that, which is the whole zero-overhead story.
    """

    def __init__(self, tracer: Optional[SpanTracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 profiler: Optional[HotLoopProfiler] = None):
        self.tracer = tracer
        self.metrics = metrics
        self.profiler = profiler

    @classmethod
    def make(cls, arg: Union[None, bool, dict, "Obs"]) -> Optional["Obs"]:
        """Normalize the ``obs=`` constructor argument.

        ``None``/``False`` → ``None`` (fully off); ``True`` → all three
        facilities; a dict like ``{"spans": True, "metrics": True,
        "profile": False}`` → selective; an :class:`Obs` instance →
        itself (sharing one bundle across runs is allowed — e.g. one
        registry scraped across a sweep).
        """
        if arg is None or arg is False:
            return None
        if isinstance(arg, Obs):
            return arg
        if arg is True:
            return cls(SpanTracer(), MetricsRegistry(), HotLoopProfiler())
        if isinstance(arg, dict):
            return cls(
                tracer=SpanTracer() if arg.get("spans", True) else None,
                metrics=MetricsRegistry() if arg.get("metrics", True)
                else None,
                profiler=HotLoopProfiler() if arg.get("profile", True)
                else None)
        raise TypeError(f"obs must be bool/dict/Obs/None, got {arg!r}")

    def export(self, out_dir: str) -> dict[str, str]:
        """Write every enabled facility's artifact into ``out_dir``:
        ``spans.jsonl``, ``metrics.prom``, ``metrics.json``,
        ``profile.json``.  Returns {artifact-name: path} for what was
        written."""
        os.makedirs(out_dir, exist_ok=True)
        written: dict[str, str] = {}
        if self.tracer is not None:
            p = os.path.join(out_dir, "spans.jsonl")
            self.tracer.dump_jsonl(p)
            written["spans"] = p
        if self.metrics is not None:
            p = os.path.join(out_dir, "metrics.prom")
            with open(p, "w") as f:
                f.write(self.metrics.to_prometheus())
            written["metrics_prom"] = p
            p = os.path.join(out_dir, "metrics.json")
            self.metrics.dump_json(p)
            written["metrics_json"] = p
        if self.profiler is not None:
            p = os.path.join(out_dir, "profile.json")
            with open(p, "w") as f:
                json.dump(self.profiler.snapshot(), f, indent=1,
                          sort_keys=True)
                f.write("\n")
            written["profile"] = p
        return written
