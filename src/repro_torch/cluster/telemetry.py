"""Windowed fleet telemetry: the feedback signal of the online weight tuner
(copy of ``repro/cluster/telemetry.py``).

The fleet tuner (``repro_torch.cluster.router.TunedScoreRouter``) needs the
same kind of feedback the per-node (alpha, beta) probe gets from UXCost
windows — but at fleet scale, where no single simulator owns the
statistics.  This module aggregates them: :class:`FleetTelemetry`
snapshots the fleet at placement-generation boundaries (the tune ticks of
the JAX package's fleet simulator) and emits one :class:`TelemetryWindow`
per interval, each a *delta* over the previous snapshot:

  * fleet UXCost of the window (Algorithm 2 over the window's per-model
    frame/energy deltas, generation-canonicalized) — the scalar the tuner
    probe minimizes;
  * per-node deadline-violation rates (which nodes degraded this window);
  * backlog percentiles across live nodes (p50 / p90 / max of summed
    to-go latency) — the live pressure signal;
  * migration count and transfer-energy spend charged in the window;
  * per-stream UXCost deltas (``"s<sid>"`` canonical prefix), so a tuner
    or an operator can see *which* streams paid for a bad weight vector.

Invariants:

  * windows are pure deltas: merging every window's per-model frame counts
    reproduces the fleet totals (finalization aside);
  * a window with zero completed frames reports ``uxcost = 0.0`` and
    ``frames = 0`` — consumers (the tuner) treat it as *no signal* and
    hold their committed parameters rather than chase a vacuous zero;
  * snapshots read only cheap per-node state (window stats + telemetry
    gauges); nothing here perturbs any RNG stream, so telemetry can be
    attached to any run without disturbing determinism.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.uxcost import (ModelWindowStats, WindowStats,
                          overall_dlv_rate, uxcost)


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolation percentile of an ascending list (0 for empty)."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclass(frozen=True)
class TelemetryWindow:
    """One fleet feedback interval: deltas between consecutive snapshots."""

    t0: float
    t1: float
    frames: int                       # frames completed fleet-wide
    violated: int                     # of which deadline-violated
    dlv_rate: float                   # violated / frames (0 when empty)
    uxcost: float                     # Algorithm-2 UXCost of the window
    node_dlv: dict[int, float]        # per live node: window DLV rate
    node_frames: dict[int, int]       # per live node: frames this window
    backlog_p50: float                # percentiles of per-node backlog_s
    backlog_p90: float
    backlog_max: float
    migrations: int                   # migrations charged in the window
    xfer_j: float                     # transfer energy charged in the window
    stream_uxcost: dict[str, float]   # per-stream ("s<sid>") UXCost delta
    n_models: int = 0                 # models that completed frames
    pipe_frames: int = 0              # pipelines completed head-to-tail
    pipe_latency_s: float = 0.0       # summed head-to-tail latency (s)
    departures: int = 0               # stream departures in the window
    rejections: int = 0               # SLO admission rejections in the window
    swaps: int = 0                    # SLO variant swaps in the window

    @property
    def norm_uxcost(self) -> float:
        """Window UXCost normalized by the active-model count squared.

        Raw Algorithm-2 UXCost is a product of two per-model *sums*, so it
        scales ~quadratically with how many models completed frames in the
        window.  Under a drifting workload consecutive windows see
        different populations (arrival ramps, load swings), which would
        bias any probe that compares candidates measured in *different*
        windows toward whichever one ran when the fleet was emptier.
        Dividing by ``n_models**2`` makes the signal approximately
        population-invariant (≈ mean DLV rate × mean NormEnergy) — this is
        the cost the weight tuner minimizes."""
        if self.n_models == 0:
            return 0.0
        return self.uxcost / float(self.n_models) ** 2

    @property
    def mean_pipeline_latency_s(self) -> float:
        """Mean head-to-tail pipeline latency over the window's completed
        pipelines (0 when none completed) — the end-to-end metric next to
        the per-model DLV rates."""
        return self.pipe_latency_s / self.pipe_frames if self.pipe_frames \
            else 0.0

    @property
    def empty(self) -> bool:
        """True when the window carries no feedback signal (no frames
        completed — e.g. a zero-length window between same-time ticks).
        Tuners must fall back to their committed parameters on empty
        windows instead of treating the vacuous 0-cost as a measurement."""
        return self.frames == 0


class FleetTelemetry:
    """Snapshot-differencing aggregator over a live fleet.

    ``observe(t, nodes, migrations, xfer_energy)`` is called by the fleet
    simulator at each tune tick with the current node map and the
    cumulative migration/transfer counters; it returns the
    :class:`TelemetryWindow` covering the interval since the previous call
    (the first call covers from fleet start) and appends it to
    :attr:`windows`.
    """

    def __init__(self, canonical=None):
        #: name canonicalizer applied to per-model stats (the fleet passes
        #: ``canonical_stream_model`` so placement generations and stage
        #: splits collapse to one logical model per stream)
        self.canonical = canonical or (lambda name: name)
        self.windows: list[TelemetryWindow] = []
        self._t_last = 0.0
        #: per canonical model: (frames, violated, energy, worst_energy,
        #: pipe_frames, pipe_latency_s) cumulative at the last snapshot
        self._last: dict[str, tuple] = {}
        self._last_by_node: dict[int, tuple[int, int]] = {}
        self._last_migrations = 0
        self._last_xfer_j = 0.0
        self._last_departures = 0
        self._last_rejections = 0
        self._last_swaps = 0

    # ------------------------------------------------------------ snapshot
    def _cumulative(self, nodes: dict) -> tuple[
            dict[str, tuple], dict[int, tuple[int, int]]]:
        """Fleet-cumulative per-canonical-model stats and per-node frame
        counters.  Reads each node's merged global stats plus the open
        UXCost window, so tune ticks need not align with node windows."""
        per_model: dict[str, tuple] = {}
        per_node: dict[int, tuple[int, int]] = {}
        for nid in sorted(nodes):
            node = nodes[nid]
            nf = nv = 0
            for stats in (node.sim.global_stats, node.sim.window_stats):
                for name, st in stats.per_model.items():
                    cname = self.canonical(name)
                    f, v, e, w, qf, ql = per_model.get(
                        cname, (0, 0, 0.0, 0.0, 0, 0.0))
                    per_model[cname] = (f + st.frames, v + st.violated,
                                        e + st.energy_j,
                                        w + st.worst_energy_j,
                                        qf + st.pipe_frames,
                                        ql + st.pipe_latency_s)
                    nf += st.frames
                    nv += st.violated
            per_node[nid] = (nf, nv)
        return per_model, per_node

    def observe(self, t: float, nodes: dict, migrations: int,
                xfer_energy_j: float,
                departures: int = 0, rejections: int = 0,
                swaps: int = 0) -> TelemetryWindow:
        """Close the current window at fleet time ``t`` and return it.
        ``departures`` / ``rejections`` / ``swaps`` are the fleet's
        cumulative counters (the window reports deltas, like
        migrations)."""
        cum, by_node = self._cumulative(nodes)
        delta = WindowStats()
        for cname in sorted(cum):
            f, v, e, w, qf, ql = cum[cname]
            pf, pv, pe, pw, pqf, pql = self._last.get(
                cname, (0, 0, 0.0, 0.0, 0, 0.0))
            if f - pf > 0 or w - pw > 0.0:
                delta.per_model[cname] = ModelWindowStats(
                    frames=f - pf, violated=v - pv, energy_j=e - pe,
                    worst_energy_j=w - pw, pipe_frames=qf - pqf,
                    pipe_latency_s=ql - pql)
        node_dlv: dict[int, float] = {}
        node_frames: dict[int, int] = {}
        for nid in sorted(by_node):
            f, v = by_node[nid]
            pf, pv = self._last_by_node.get(nid, (0, 0))
            df, dv = f - pf, v - pv
            node_frames[nid] = df
            node_dlv[nid] = dv / df if df > 0 else 0.0
        backlogs = sorted(
            nodes[nid].telemetry().backlog_s
            for nid in sorted(nodes) if nodes[nid].alive)
        frames = sum(st.frames for st in delta.per_model.values())
        stream_ux = {}
        by_stream: dict[str, WindowStats] = {}
        for cname, st in delta.per_model.items():
            sid = cname.split(".", 1)[0]
            by_stream.setdefault(sid, WindowStats()).per_model[cname] = st
        for sid in sorted(by_stream):
            stream_ux[sid] = uxcost(by_stream[sid])
        win = TelemetryWindow(
            t0=self._t_last, t1=t,
            frames=frames,
            violated=sum(st.violated for st in delta.per_model.values()),
            dlv_rate=overall_dlv_rate(delta),
            uxcost=uxcost(delta),
            node_dlv=node_dlv,
            node_frames=node_frames,
            backlog_p50=_percentile(backlogs, 0.50),
            backlog_p90=_percentile(backlogs, 0.90),
            backlog_max=backlogs[-1] if backlogs else 0.0,
            migrations=migrations - self._last_migrations,
            xfer_j=xfer_energy_j - self._last_xfer_j,
            stream_uxcost=stream_ux,
            n_models=sum(1 for st in delta.per_model.values()
                         if st.frames > 0),
            pipe_frames=sum(st.pipe_frames
                            for st in delta.per_model.values()),
            pipe_latency_s=sum(st.pipe_latency_s
                               for st in delta.per_model.values()),
            departures=departures - self._last_departures,
            rejections=rejections - self._last_rejections,
            swaps=swaps - self._last_swaps,
        )
        self.windows.append(win)
        self._t_last = t
        self._last = cum
        self._last_by_node = by_node
        self._last_migrations = migrations
        self._last_xfer_j = xfer_energy_j
        self._last_departures = departures
        self._last_rejections = rejections
        self._last_swaps = swaps
        return win
