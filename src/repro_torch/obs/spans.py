"""Span-based structured tracing with a pipeline critical-path extractor
(copy of ``repro/obs/spans.py``).

A *span* is one named interval of simulated time with attributes:
``{"sid": int, "kind": str, "t0": float, "t1": float, "attrs": {...}}``.
:class:`SpanTracer` hands out span IDs from a plain counter — never from
wall clocks or RNG — so a traced run's span stream is a pure function of
the simulated execution and traced runs stay replay-bit-exact (the same
guarantee the JAX package's trace replay relies on).  The simulator and fleet
open/close spans at the event sites that matter:

  ====================  =================================================
  kind                  opened / closed at
  ====================  =================================================
  ``job``               node job lifecycle: created at enqueue, closed at
                        complete / drop / purge, carrying queue+exec
                        segments, energy, deadline outcome, parent link
  ``xfer``              cross-node cascade handoff riding a contended
                        link (wire-time interval, bytes, joules)
  ``place``/``migrate`` router placement decisions and live migrations
  ``admit``/``reject``  admission verdicts with pressure-term breakdown
  ``swap``              SLO supernet-variant ladder moves
  ``stream``/``depart`` stream lifecycle; ``node_join``/``node_leave``/
                        ``node_drain``/``rejoin`` fleet churn
  ``tune``/``slo_tick`` controller windows (weights, pressure terms)
  ====================  =================================================

Spans serialize as JSONL (:meth:`SpanTracer.dump_jsonl`), one record per
line, schema-checked by :func:`validate_span`.

:func:`critical_path` is the *why* tool: given a frame-pipeline's tail
job span it walks the parent chain back to the head arrival and explains
the whole head-to-tail latency as a sum of named segments —
``queue`` (enqueue→first dispatch), ``exec`` (dispatch blocks),
``stall`` (gaps between a job's exec blocks), ``transfer`` (cross-node
wire time) and ``handoff_wait`` (trigger→inject residue).  The segment
sums telescope: they reconcile exactly with the recorded
``overall_pipeline_latency`` contribution (``t_done - origin``) of that
frame, which the obs test-suite asserts on whole-model, stage-split and
SLO-overload runs.
"""
from __future__ import annotations

import itertools
import json
from typing import Iterable, Optional

_REQUIRED_KEYS = ("sid", "kind", "t0", "t1", "attrs")


class SpanError(ValueError):
    """Raised on malformed span records."""


def validate_span(rec: dict) -> dict:
    """Schema-check one span record; returns it unchanged or raises
    :class:`SpanError`.  Used by the CI ``obs_smoke`` stage on every line
    of an emitted span file."""
    if not isinstance(rec, dict):
        raise SpanError(f"span must be a dict, got {type(rec).__name__}")
    missing = [k for k in _REQUIRED_KEYS if k not in rec]
    if missing:
        raise SpanError(f"span missing keys {missing}: {rec!r}")
    if not isinstance(rec["sid"], int):
        raise SpanError(f"span sid must be int: {rec!r}")
    if not isinstance(rec["kind"], str) or not rec["kind"]:
        raise SpanError(f"span kind must be non-empty str: {rec!r}")
    for k in ("t0", "t1"):
        if not isinstance(rec[k], (int, float)):
            raise SpanError(f"span {k} must be numeric: {rec!r}")
    if rec["t1"] < rec["t0"]:
        raise SpanError(f"span ends before it starts: {rec!r}")
    if not isinstance(rec["attrs"], dict):
        raise SpanError(f"span attrs must be a dict: {rec!r}")
    return rec


class SpanTracer:
    """Deterministic span recorder.

    IDs come from :func:`itertools.count` — creation order *is* identity,
    so two bit-identical runs emit bit-identical span streams.  ``open``
    returns the span id; ``close`` stamps the end time and merges final
    attributes; ``event`` records an instantaneous span (``t0 == t1``);
    ``span`` records an interval known up front (e.g. a wire transfer).
    Unclosed spans are finalized by :meth:`finish` with
    ``outcome="unfinished"`` so the JSONL is always complete.
    """

    def __init__(self):
        self._ids = itertools.count()
        #: closed spans in close order (dicts per the module schema)
        self.records: list[dict] = []
        #: open spans: sid -> record-in-progress
        self._open: dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self.records) + len(self._open)

    # ------------------------------------------------------------ recording
    def open(self, kind: str, t: float, **attrs) -> int:
        sid = next(self._ids)
        self._open[sid] = {"sid": sid, "kind": kind, "t0": float(t),
                           "t1": float(t), "attrs": dict(attrs)}
        return sid

    def close(self, sid: int, t: float, **attrs) -> None:
        rec = self._open.pop(sid, None)
        if rec is None:
            raise SpanError(f"close of unknown/closed span {sid}")
        rec["t1"] = float(t)
        rec["attrs"].update(attrs)
        self.records.append(rec)

    def event(self, kind: str, t: float, **attrs) -> int:
        """Instantaneous span (t0 == t1): a decision point, not a wait."""
        sid = next(self._ids)
        self.records.append({"sid": sid, "kind": kind, "t0": float(t),
                             "t1": float(t), "attrs": dict(attrs)})
        return sid

    def span(self, kind: str, t0: float, t1: float, **attrs) -> int:
        """Record an interval whose extent is already known."""
        sid = next(self._ids)
        self.records.append({"sid": sid, "kind": kind, "t0": float(t0),
                             "t1": float(t1), "attrs": dict(attrs)})
        return sid

    def finish(self, t: float) -> None:
        """Close any still-open spans at ``t`` with outcome=unfinished."""
        for sid in sorted(self._open):
            rec = self._open.pop(sid)
            rec["t1"] = max(float(t), rec["t0"])
            rec["attrs"].setdefault("outcome", "unfinished")
            self.records.append(rec)

    # ------------------------------------------------------------- export
    def to_records(self) -> list[dict]:
        """All closed spans, sorted by (t0, sid) for stable replay diffs."""
        return sorted(self.records, key=lambda r: (r["t0"], r["sid"]))

    def dump_jsonl(self, path: str) -> int:
        """Write one JSON object per line; returns the record count."""
        recs = self.to_records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(validate_span(rec), sort_keys=True))
                f.write("\n")
        return len(recs)


def load_jsonl(path: str) -> list[dict]:
    """Read and validate a span JSONL file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(validate_span(json.loads(line)))
    return out


# ---------------------------------------------------------------- critical path

def _job_segments(rec: dict) -> list[dict]:
    """Decompose one job span into queue / exec / stall segments.

    ``attrs.segs`` is the list of ``[t_dispatch, t_done]`` execution
    blocks the simulator recorded (a job dispatches once per path
    position).  Everything between enqueue and the first dispatch is
    ``queue``; gaps between blocks are ``stall`` (the accelerator ran
    other jobs in between); the blocks themselves are ``exec``.  The
    segments tile [t0, t1] exactly, so their durations always sum to the
    span extent.
    """
    segs: list[dict] = []
    cursor = rec["t0"]
    blocks = rec["attrs"].get("segs") or []
    for i, (b0, b1) in enumerate(blocks):
        if b0 > cursor:
            segs.append({"seg": "queue" if i == 0 else "stall",
                         "t0": cursor, "t1": b0})
        segs.append({"seg": "exec", "t0": b0, "t1": b1})
        cursor = b1
    if rec["t1"] > cursor:
        # closed after the last block finished (drop/purge tail residue)
        segs.append({"seg": "stall" if blocks else "queue",
                     "t0": cursor, "t1": rec["t1"]})
    return segs


def critical_path(records: Iterable[dict],
                  tail_uid: Optional[str] = None) -> dict:
    """Explain one pipeline's head-to-tail latency as named segments.

    Picks the tail job span (``attrs.tail`` true, ``outcome == "done"``;
    or the one with ``attrs.uid == tail_uid``), walks ``attrs.parent``
    links back to the head job, and splices per-job queue/exec/stall
    segments with inter-job ``transfer`` + ``handoff_wait`` edges.  The
    returned dict has:

      * ``segments`` — list of ``{"seg", "t0", "t1", "uid"}`` tiling
        ``[origin, t_done]`` with no gaps or overlaps;
      * ``by_seg`` — summed seconds per segment name;
      * ``total_s`` — ``t_done - origin``, which equals the sum of all
        segment durations (the reconciliation invariant) and matches this
        frame's contribution to ``overall_pipeline_latency``;
      * ``chain`` — the job uids head→tail.

    When the head job's enqueue time sits after the recorded ``origin``
    (a cascade trigger fired mid-frame), the leading gap is labeled
    ``handoff_wait`` so the telescoping still covers the full interval.
    """
    jobs = {r["attrs"]["uid"]: r for r in records
            if r["kind"] == "job" and "uid" in r["attrs"]}
    if tail_uid is not None:
        tail = jobs.get(tail_uid)
        if tail is None:
            raise SpanError(f"no job span with uid {tail_uid!r}")
    else:
        done_tails = [r for r in jobs.values()
                      if r["attrs"].get("tail")
                      and r["attrs"].get("outcome") == "done"]
        if not done_tails:
            raise SpanError("no completed tail job span in records")
        # latest-finishing tail = the frame most likely being asked about
        tail = max(done_tails, key=lambda r: (r["t1"], r["sid"]))

    chain = [tail]
    seen = {tail["attrs"]["uid"]}
    while True:
        parent = chain[-1]["attrs"].get("parent")
        if parent is None or parent not in jobs or parent in seen:
            break
        chain.append(jobs[parent])
        seen.add(parent)
    chain.reverse()  # head first

    origin = float(chain[0]["attrs"].get("origin", chain[0]["t0"]))
    segments: list[dict] = []
    cursor = origin
    for i, rec in enumerate(chain):
        uid = rec["attrs"]["uid"]
        if rec["t0"] > cursor:
            gap_t0, gap_t1 = cursor, rec["t0"]
            if i > 0:
                # split the inter-job edge: wire time first, residue waits
                xfer_s = min(float(rec["attrs"].get("xfer_s", 0.0)),
                             gap_t1 - gap_t0)
                if xfer_s > 0.0:
                    segments.append({"seg": "transfer", "t0": gap_t0,
                                     "t1": gap_t0 + xfer_s, "uid": uid})
                    gap_t0 += xfer_s
            if gap_t1 > gap_t0:
                segments.append({"seg": "handoff_wait", "t0": gap_t0,
                                 "t1": gap_t1, "uid": uid})
            cursor = rec["t0"]
        for seg in _job_segments(rec):
            if seg["t1"] <= cursor:
                continue  # overlapped by a later-chain start (clamped)
            segments.append({**seg, "t0": max(seg["t0"], cursor),
                             "uid": uid})
            cursor = segments[-1]["t1"]

    by_seg: dict[str, float] = {}
    for seg in segments:
        by_seg[seg["seg"]] = by_seg.get(seg["seg"], 0.0) \
            + (seg["t1"] - seg["t0"])
    return {"segments": segments, "by_seg": by_seg,
            "total_s": cursor - origin,
            "t0": origin, "t1": cursor,
            "chain": [r["attrs"]["uid"] for r in chain]}


def pipeline_tails(records: Iterable[dict]) -> list[dict]:
    """All completed tail job spans, ordered by finish time — the
    per-frame entry points for :func:`critical_path`."""
    return sorted((r for r in records
                   if r["kind"] == "job" and r["attrs"].get("tail")
                   and r["attrs"].get("outcome") == "done"),
                  key=lambda r: (r["t1"], r["sid"]))
