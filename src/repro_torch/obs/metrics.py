"""Metrics registry: counters / gauges / histograms with label sets (copy
of ``repro/obs/metrics.py``).

The fleet's quantitative surface — in the JAX package the fleet simulator,
admission controller, contended links and weight tuner; here the fleet
server (``repro_torch.launch.serve_fleet``) and the weight tuner — publish
into one :class:`MetricsRegistry` when observability is enabled, and the
result exports two ways:

  * :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
    format (``# HELP`` / ``# TYPE`` headers, label-set samples, histogram
    ``_bucket``/``_sum``/``_count`` expansion), scrape-ready;
  * :meth:`MetricsRegistry.snapshot` — a JSON-serializable dict, the
    machine-readable side consumed by ``scripts/report.py``.

:func:`parse_prometheus` is the matching strict parser (used by the CI
``obs_smoke`` stage to prove the export is well-formed — and by anyone who
wants samples back out of a ``.prom`` file without a Prometheus server).

Design constraints, inherited from the simulator's determinism contract:

  * publishing is observation only — no RNG, no floats fed back into any
    decision path, so metered runs stay bit-identical to unmetered ones;
  * label values are stringified on publish and label *names* are fixed at
    metric registration, so one metric's children always share a schema;
  * everything is plain Python dicts — cheap enough for per-frame counters
    on the simulator hot path, dependency-free by construction.
"""
from __future__ import annotations

import json
import math
import re
from typing import Optional, Sequence

#: default histogram buckets (seconds): spans sub-ms kernel latencies to
#: multi-second pipeline stalls; +Inf is implicit
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricsError(ValueError):
    """Raised on malformed metric registrations or exports."""


def _escape(value: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


class Metric:
    """One named metric: a family of children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise MetricsError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricsError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        #: label-values tuple -> child state (float for counter/gauge)
        self.children: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise MetricsError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _sample_name(self, key: tuple[str, ...]) -> str:
        if not key:
            return self.name
        inner = ",".join(f'{ln}="{_escape(v)}"'
                         for ln, v in zip(self.labelnames, key))
        return f"{self.name}{{{inner}}}"


class Counter(Metric):
    """Monotone counter; ``inc`` only."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MetricsError(f"{self.name}: counters only increase")
        key = self._key(labels)
        self.children[key] = self.children.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return float(self.children.get(self._key(labels), 0.0))


class Gauge(Metric):
    """Point-in-time value; ``set`` (and ``inc`` for convenience)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.children[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        self.children[key] = self.children.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return float(self.children.get(self._key(labels), 0.0))


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise MetricsError(f"{name}: buckets must strictly increase")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        st = self.children.get(key)
        if st is None:
            st = {"counts": [0] * len(self.buckets), "sum": 0.0, "count": 0}
            self.children[key] = st
        v = float(value)
        st["sum"] += v
        st["count"] += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                st["counts"][i] += 1


class MetricsRegistry:
    """Get-or-create metric store with Prometheus / JSON export."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str,
             labelnames: Sequence[str], **kw) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labelnames != tuple(labelnames):
                raise MetricsError(
                    f"{name} already registered as {m.kind} with labels "
                    f"{m.labelnames}")
            return m
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    # ------------------------------------------------------------- export
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key in sorted(m.children):
                st = m.children[key]
                if isinstance(m, Histogram):
                    cum = 0
                    for ub, c in zip(m.buckets, st["counts"]):
                        cum += c
                        le = format(ub, "g")
                        k2 = key + (le,)
                        ln2 = m.labelnames + ("le",)
                        inner = ",".join(
                            f'{ln}="{_escape(v)}"'
                            for ln, v in zip(ln2, k2))
                        lines.append(
                            f"{m.name}_bucket{{{inner}}} {cum}")
                    inner = ",".join(
                        f'{ln}="{_escape(v)}"'
                        for ln, v in zip(m.labelnames + ("le",),
                                         key + ("+Inf",)))
                    lines.append(
                        f"{m.name}_bucket{{{inner}}} {st['count']}")
                    suffix = m._sample_name(key)
                    base, _, rest = suffix.partition("{")
                    tail = ("{" + rest) if rest else ""
                    lines.append(f"{base}_sum{tail} {format(st['sum'], 'g')}")
                    lines.append(f"{base}_count{tail} {st['count']}")
                else:
                    lines.append(
                        f"{m._sample_name(key)} {format(st, 'g')}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """JSON-serializable dump: {metric: {type, help, labels, samples}}."""
        out: dict[str, dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            samples = []
            for key in sorted(m.children):
                st = m.children[key]
                labels = dict(zip(m.labelnames, key))
                if isinstance(m, Histogram):
                    samples.append({"labels": labels, "sum": st["sum"],
                                    "count": st["count"],
                                    "buckets": dict(zip(
                                        (format(b, "g") for b in m.buckets),
                                        st["counts"]))})
                else:
                    samples.append({"labels": labels, "value": st})
            out[name] = {"type": m.kind, "help": m.help,
                         "labelnames": list(m.labelnames),
                         "samples": samples}
        return out

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_PAIR_RE = re.compile(
    r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> list[dict]:
    """Strict parser for the text exposition format; returns one
    ``{"name", "labels", "value"}`` dict per sample and raises
    :class:`MetricsError` on any malformed line — the CI smoke's proof
    that :meth:`MetricsRegistry.to_prometheus` emits valid exposition."""
    samples: list[dict] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise MetricsError(f"line {lineno}: bad comment {raw!r}")
            if parts[1] == "TYPE" and (
                    len(parts) < 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped")):
                raise MetricsError(f"line {lineno}: bad TYPE {raw!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise MetricsError(f"line {lineno}: unparsable sample {raw!r}")
        labels: dict[str, str] = {}
        body = m.group("labels")
        if body:
            consumed = 0
            for pair in _LABEL_PAIR_RE.finditer(body):
                labels[pair.group("name")] = _unescape(pair.group("value"))
                consumed = pair.end()
                if consumed < len(body) and body[consumed] == ",":
                    consumed += 1
            if consumed < len(body):
                raise MetricsError(
                    f"line {lineno}: bad label body {body!r}")
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise MetricsError(f"line {lineno}: bad value {raw!r}") from e
        if math.isnan(value):
            raise MetricsError(f"line {lineno}: NaN sample {raw!r}")
        samples.append({"name": m.group("name"), "labels": labels,
                        "value": value})
    return samples
