"""Render a run's spans + metrics + profile into a terminal/markdown report
(copy of ``repro/obs/report.py``).

Pure functions from exported observability artifacts (the files
:meth:`repro_torch.obs.Obs.export` writes) to text — the engine behind
``scripts/report.py``.  Each section degrades gracefully when its input
is absent, so a spans-only or metrics-only run still renders.

Sections:

  * :func:`render_timeline` — fleet event timeline (placements, churn,
    admissions, migrations, controller ticks) in sim-time order;
  * :func:`render_tier_dlv` — per-SLO-tier frames / deadline-violation
    breakdown read from the metrics snapshot;
  * :func:`render_pressure` — pressure-law term attribution for every
    degrade / reject decision (which term tripped the threshold);
  * :func:`render_critical_paths` — the N slowest completed pipelines,
    each explained as queue/exec/stall/transfer/handoff segments via
    :func:`repro_torch.obs.spans.critical_path`;
  * :func:`render_profile` — the hot-loop "where the wall-clock goes"
    table.
"""
from __future__ import annotations

from typing import Optional

from .spans import critical_path, pipeline_tails

#: span kinds shown on the fleet timeline (job spans are too many; they
#: surface through the critical-path section instead)
_TIMELINE_KINDS = ("node_join", "node_leave", "node_drain", "rejoin",
                   "stream", "depart", "place", "migrate", "admit",
                   "reject", "swap", "tune", "slo_tick", "xfer")


def _fmt_attrs(attrs: dict, keys: tuple[str, ...]) -> str:
    parts = []
    for k in keys:
        if k in attrs and attrs[k] is not None:
            v = attrs[k]
            parts.append(f"{k}={v:.4g}" if isinstance(v, float)
                         else f"{k}={v}")
    return " ".join(parts)


def render_timeline(records: list[dict], max_rows: int = 60) -> str:
    """Sim-time-ordered fleet event timeline (markdown table)."""
    rows = [r for r in records if r["kind"] in _TIMELINE_KINDS]
    rows.sort(key=lambda r: (r["t0"], r["sid"]))
    clipped = len(rows) - max_rows
    if clipped > 0:
        # keep an even spread rather than only the head of the run
        stride = len(rows) / max_rows
        rows = [rows[int(i * stride)] for i in range(max_rows)]
    lines = ["| t (s) | event | detail |", "|---|---|---|"]
    for r in rows:
        a = r["attrs"]
        detail = _fmt_attrs(a, ("node", "stream", "model", "tier",
                                "level", "verdict", "pressure", "src",
                                "dst", "xfer_s", "xfer_j", "uxcost"))
        t = (f"{r['t0']:.3f}" if r["t0"] == r["t1"]
             else f"{r['t0']:.3f}–{r['t1']:.3f}")
        lines.append(f"| {t} | {r['kind']} | {detail} |")
    if clipped > 0:
        lines.append(f"\n*({clipped} events elided — evenly sampled)*")
    return "\n".join(lines)


def render_tier_dlv(metrics_snapshot: dict) -> str:
    """Per-tier frames / violation table from the metrics snapshot."""
    frames = metrics_snapshot.get("fleet_tier_frames_total", {})
    dlv = metrics_snapshot.get("fleet_tier_dlv_rate", {})
    by_tier: dict[str, dict] = {}
    for s in frames.get("samples", ()):
        by_tier.setdefault(s["labels"].get("tier", "?"), {})["frames"] = \
            s["value"]
    for s in dlv.get("samples", ()):
        by_tier.setdefault(s["labels"].get("tier", "?"), {})["dlv"] = \
            s["value"]
    if not by_tier:
        return "*(no per-tier metrics in snapshot)*"
    lines = ["| tier | frames | DLV rate |", "|---|---|---|"]
    for tier in sorted(by_tier):
        row = by_tier[tier]
        lines.append(f"| {tier} | {row.get('frames', 0):.0f} "
                     f"| {row.get('dlv', 0.0):.4f} |")
    return "\n".join(lines)


def render_pressure(records: list[dict], max_rows: int = 40) -> str:
    """Pressure-law term attribution for degrade / reject decisions.

    Each admission verdict span carries the controller's ``terms`` dict
    (util / forecast / dlv / backlog / latency contributions summing to
    the pressure P).  The dominant term is flagged — that's the *why*
    behind every shed decision.
    """
    rows = [r for r in records
            if r["kind"] in ("reject", "swap", "admit")
            and r["attrs"].get("terms")]
    rows.sort(key=lambda r: (r["t0"], r["sid"]))
    if not rows:
        return "*(no admission/degrade decisions with pressure terms)*"
    shown = rows[:max_rows]
    lines = ["| t (s) | action | target | P | dominant term | terms |",
             "|---|---|---|---|---|---|"]
    for r in shown:
        a = r["attrs"]
        terms = a["terms"]
        dom = max(terms, key=lambda k: terms[k]) if terms else "-"
        tstr = " ".join(f"{k}={v:.3f}" for k, v in sorted(terms.items()))
        target = a.get("stream", a.get("model", ""))
        lines.append(
            f"| {r['t0']:.3f} | {r['kind']} | {target} "
            f"| {a.get('pressure', 0.0):.3f} "
            f"| {dom}={terms.get(dom, 0.0):.3f} | {tstr} |")
    if len(rows) > len(shown):
        lines.append(f"\n*({len(rows) - len(shown)} more decisions "
                     "elided)*")
    return "\n".join(lines)


def render_critical_paths(records: list[dict], n: int = 3) -> str:
    """The ``n`` slowest completed pipelines, segment by segment."""
    tails = pipeline_tails(records)
    if not tails:
        return "*(no completed pipelines in span records)*"
    scored = sorted(
        tails, key=lambda r: r["t1"] - float(
            r["attrs"].get("origin", r["t0"])), reverse=True)[:n]
    out = []
    for rank, tail in enumerate(scored, 1):
        cp = critical_path(records, tail_uid=tail["attrs"]["uid"])
        head = f"**#{rank} pipeline → {tail['attrs']['uid']}** " \
               f"(model {tail['attrs'].get('model', '?')}): " \
               f"{cp['total_s'] * 1e3:.2f} ms over {len(cp['chain'])} " \
               f"job(s)"
        segs = " + ".join(
            f"{name} {cp['by_seg'][name] * 1e3:.2f}ms"
            for name in sorted(cp["by_seg"],
                               key=lambda k: -cp["by_seg"][k]))
        chain = " → ".join(cp["chain"])
        out.append(f"{head}\n- segments: {segs}\n- chain: {chain}")
    return "\n\n".join(out)


def render_profile(profile_snapshot: dict, n: int = 12) -> str:
    """Hot-loop wall-time table from a profiler snapshot."""
    keys = profile_snapshot.get("keys", {})
    if not keys:
        return "*(no profile samples)*"
    rows = sorted(keys.items(), key=lambda kv: -kv[1]["wall_s"])[:n]
    metered = sum(v["wall_s"] for v in keys.values())
    lines = ["| key | wall (s) | calls | us/call | share |",
             "|---|---|---|---|---|"]
    for key, v in rows:
        c = v["count"]
        us = v["wall_s"] / c * 1e6 if c else 0.0
        share = v["wall_s"] / metered if metered else 0.0
        lines.append(f"| {key} | {v['wall_s']:.4f} | {c} "
                     f"| {us:.1f} | {share:.1%} |")
    total = profile_snapshot.get("total_wall_s", 0.0)
    if total:
        lines.append(f"\n*metered {metered:.4f}s of {total:.4f}s run "
                     "wall-clock*")
    return "\n".join(lines)


def render_report(records: Optional[list[dict]] = None,
                  metrics_snapshot: Optional[dict] = None,
                  profile_snapshot: Optional[dict] = None,
                  title: str = "Run report",
                  n_paths: int = 3,
                  timeline_rows: int = 60) -> str:
    """Full markdown report from whichever artifacts are present."""
    parts = [f"# {title}"]
    if records:
        parts.append("## Fleet timeline\n\n"
                     + render_timeline(records, max_rows=timeline_rows))
        parts.append("## Slowest pipelines (critical paths)\n\n"
                     + render_critical_paths(records, n=n_paths))
        parts.append("## Pressure-law attribution\n\n"
                     + render_pressure(records))
    if metrics_snapshot:
        parts.append("## Per-tier DLV\n\n"
                     + render_tier_dlv(metrics_snapshot))
    if profile_snapshot:
        parts.append("## Hot-loop profile\n\n"
                     + render_profile(profile_snapshot))
    return "\n\n".join(parts) + "\n"
