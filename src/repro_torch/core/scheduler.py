"""The DREAM scheduler (Section 4): MapScore-driven job assignment with the
smart frame drop engine, Supernet switching, and the online (alpha, beta)
adaptivity engine.

Configurations mirror the paper's Table 4:
  DREAM-MapScore  : score-driven dispatch + online parameter optimization
  DREAM-SmartDrop : + smart frame drop
  DREAM-Full      : + Supernet switching
(and `adaptivity=False` gives the fixed alpha=beta=1 ablation of Figure 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .adaptivity import PARAM_HI, PARAM_LO, ProbeSearch
from .costmodel import CostTable, E_DRAM
from .mapscore import (CSWITCH_MAX, MapScoreParams, STARV_MAX, URGENCY_MAX,
                       _EPS_SLACK, mapscore, togo_seconds)
from .simulator import Dispatch, Job, SchedulerBase, Simulator
from .uxcost import WindowStats, overall_dlv_rate

# the paper's constrained search range (§5.2) lives with the probe core in
# repro_torch.core.adaptivity; imported here so `scheduler.PARAM_LO/HI` keep
# resolving for existing callers
_ = (PARAM_LO, PARAM_HI)


@dataclass
class AdaptivityState(ProbeSearch):
    """Radius-shrinking online search over (alpha, beta) — Section 3.6.

    The probe state machine itself is the host-agnostic
    :class:`repro_torch.core.adaptivity.ProbeSearch` (also reused, in coordinate
    form, by the fleet weight tuner); this subclass adds the per-node
    workload-change *detector*: when the probe is parked, a DLV-rate shift
    against an EMA re-arms it.  Non-blocking: scheduling always proceeds
    with whatever candidate is under test.
    """

    dlv_ema: Optional[float] = None

    def retrigger(self, radius: float = 0.4) -> None:
        """Restart the (alpha, beta) probe from the current center — the
        response to an externally-signalled workload change (stream
        migration, node membership churn) rather than a detected DLV drift.
        Fresh candidates are drawn on the next window step."""
        super().retrigger(radius)
        self.dlv_ema = None

    def _on_stop(self) -> None:
        self.dlv_ema = None

    def step(self, window_uxcost: float, window_dlv: float,  # type: ignore[override]
             rng: np.random.Generator) -> np.ndarray:
        """Advance one UXCost window; returns the params for the next window."""
        if not self.probing:
            # workload-change detection: DLV-rate shift re-triggers the search
            if self.dlv_ema is None:
                self.dlv_ema = window_dlv
            drift = abs(window_dlv - self.dlv_ema)
            self.dlv_ema = 0.8 * self.dlv_ema + 0.2 * window_dlv
            if drift > 0.2:
                self.radius = 0.4
                self.probing = True
                self._make_candidates(rng)
            return self.center
        return ProbeSearch.step(self, window_uxcost, rng)


#: Dispatch-block cap (seconds): consecutive layers that keep preferring
#: the chosen accelerator are dispatched together up to this much latency.
#: Bounded so urgent arrivals still preempt at block boundaries; on
#: homogeneous systems (every accelerator "preferred") this makes jobs run
#: to completion in period-scale chunks instead of thrashing layer-by-layer
#: across frames — without it, urgency ordering (ToGo/Slack favors jobs
#: with MORE remaining work) starves almost-finished frames under load.
BLOCK_LATENCY_S = 1.5e-3
#: A layer "prefers" the chosen accelerator if its latency there is within
#: this factor of the best accelerator's (ties on homogeneous systems).
PREF_TOL = 1.10


class _FastTable:
    """Python-native view of one CostTable's arrays for the scalar dispatch
    fast path.  ``tolist()`` preserves the exact float64 values, and every
    per-element arithmetic step below mirrors the numpy expression in
    :func:`repro_torch.core.mapscore.mapscore` operation-for-operation, so the
    fast path is bit-identical to the vectorized reference — it only avoids
    numpy's per-call array-construction overhead for the tiny (A,) shapes
    the inner loop actually evaluates."""

    __slots__ = ("lat", "en", "lat_sum", "lat_mean", "en_sum", "in_bytes",
                 "lat_min")

    def __init__(self, table: CostTable):
        self.lat = table.lat.tolist()            # per-acc rows, floats
        self.en = table.en.tolist()
        self.lat_sum = table.lat_sum.tolist()
        self.lat_mean = table.lat_mean.tolist()
        self.en_sum = table.en_sum.tolist()
        self.in_bytes = table.in_bytes.tolist()
        self.lat_min = table.lat_min.tolist()


#: id(table.lat) -> (pinning ref, fast view).  Relabeled tables (namespaced
#: fleet copies) share the underlying arrays, so this stays at one entry per
#: structurally-distinct (model, system) pair; the pin keeps ids stable.
_FAST_TABLES: dict[int, tuple] = {}
_FAST_TABLES_MAX = 4096


def _fast_table(table: CostTable) -> _FastTable:
    key = id(table.lat)
    hit = _FAST_TABLES.get(key)
    if hit is not None and hit[0] is table.lat:
        return hit[1]
    if len(_FAST_TABLES) >= _FAST_TABLES_MAX:
        _FAST_TABLES.clear()
    ft = _FastTable(table)
    _FAST_TABLES[key] = (table.lat, ft)
    return ft


class DreamScheduler(SchedulerBase):
    def __init__(
        self,
        alpha: float = 1.0,
        beta: float = 1.0,
        adaptivity: bool = True,
        frame_drop: bool = False,
        supernet: bool = False,
        seed: int = 0,
        name: Optional[str] = None,
    ):
        self.params = MapScoreParams(alpha=alpha, beta=beta)
        self.adaptivity = adaptivity
        self.frame_drop = frame_drop
        self.supernet = supernet
        self.rng = np.random.default_rng(seed + 101)
        self.adapt = AdaptivityState(center=np.array([alpha, beta])) if adaptivity else None
        if name is not None:
            self.name = name
        elif supernet:
            self.name = "DREAM-Full"
        elif frame_drop:
            self.name = "DREAM-SmartDrop"
        elif adaptivity:
            self.name = "DREAM-MapScore"
        else:
            self.name = "MapScore-fixed"

    # ----------------------------------------------------------- adaptivity
    def retrigger_probe(self) -> None:
        """Re-arm the (alpha, beta) search after an external workload shift
        (fleet routers call this on the nodes a migration touched)."""
        if self.adapt is not None:
            self.adapt.retrigger()

    def on_window(self, sim: Simulator, stats: WindowStats, uxc: float) -> None:
        if self.adapt is None:
            return
        frames = sum(st.frames for st in stats.per_model.values())
        if frames == 0:
            return
        nxt = self.adapt.step(uxc, overall_dlv_rate(stats), self.rng)
        self.params = MapScoreParams(alpha=float(nxt[0]), beta=float(nxt[1]))

    # ------------------------------------------------------ smart frame drop
    def _smart_frame_drop(self, sim: Simulator, t: float) -> None:
        """Section 4.2.1: drop the worst (min_to_go/slack) frame meeting all
        four conditions. Triggered at every scheduling decision."""
        soa = sim.soa
        if soa is not None and len(sim.jobs) >= self.soa_batch_min:
            return self._smart_frame_drop_batch(sim, soa, t)
        # condition 2: more than one active job expected to violate
        # (counting stops at two — only the <2 threshold matters)
        nv = 0
        for j in sim.jobs.values():
            if j.done:
                continue
            mtg = j.cum_min[j.pos] if j.pos < len(j.path) else 0.0
            if mtg > max(j.deadline - t, 0.0):
                nv += 1
                if nv >= 2:
                    break
        if nv < 2:
            return
        best: tuple[float, Job] | None = None
        for j in sim.ready.values():
            slack = j.deadline - t
            mtg = j.cum_min[j.pos] if j.pos < len(j.path) else 0.0
            if mtg <= max(slack, 0.0):          # condition 1
                continue
            if not j.is_tail:                    # condition 3
                continue
            if not sim.can_drop(j.base_name):    # condition 4
                continue
            ratio = mtg / max(slack, 1e-6)
            if best is None or ratio > best[0]:
                best = (ratio, j)
        if best is not None:
            sim.drop_job(best[1], t)

    def _smart_frame_drop_batch(self, sim: Simulator, soa, t: float) -> None:
        """SoA arm of the frame-drop engine: conditions 1-3 evaluate as
        elementwise column predicates (identical float64 comparisons to the
        scalar loop), condition 4 and the strict-> ratio pick run over the
        surviving candidates in ready order — the same iteration order the
        scalar arm uses, so the chosen frame matches bit-for-bit."""
        live = soa.live_rows()              # == sim.jobs iteration order
        nviol = np.count_nonzero(
            soa.togo_min[live] > np.maximum(soa.deadline[live] - t, 0.0))
        if nviol < 2:                        # condition 2
            return
        jids = list(sim.ready)
        if not jids:
            return
        rows = np.array([soa.row_of[j] for j in jids], dtype=np.intp)
        slack = soa.deadline[rows] - t
        mtg = soa.togo_min[rows]
        cand = np.flatnonzero((mtg > np.maximum(slack, 0.0))   # condition 1
                              & soa.is_tail[rows])             # condition 3
        if not len(cand):
            return
        ratio = mtg[cand] / np.maximum(slack[cand], 1e-6)
        best: tuple[float, Job] | None = None
        for i, ci in enumerate(cand):
            j = sim.ready[jids[ci]]
            if not sim.can_drop(j.base_name):                  # condition 4
                continue
            r = float(ratio[i])
            if best is None or r > best[0]:
                best = (r, j)
        if best is not None:
            sim.drop_job(best[1], t)

    # ------------------------------------------------------ Supernet switch
    def _maybe_switch_variant(self, sim: Simulator, job: Job, t: float) -> None:
        """Section 4.5.1: at the switch point — when the job's first layer is
        actually dispatched — deploy the heaviest weight-sharing variant whose
        estimated completion meets the deadline."""
        if job.variant_locked or job.pos != 0:
            return
        job.variant_locked = True
        graph = sim.graphs[job.graph_name]
        sim.variant_counts.setdefault(job.graph_name, 0)
        if not graph.variants or job.decode_len:
            # autoregressive jobs never auto-degrade here: a chat variant
            # rung caps max_new_tokens, i.e. silently truncates the
            # response — a quality cut only the SLO ladder (which charges
            # degradation into UXCost) is entitled to take
            sim.variant_counts[job.graph_name] += 1
            return
        slack = job.slack(t)
        # autoregressive jobs are judged on the predicted profile (the
        # sampled token count is the engine's secret), classic jobs on the
        # true-path ToGo — exactly what the dispatch scorer sees
        togo0 = (job.sched_list[0] if job.sched_list is not None
                 else job.togo())
        if togo0 <= slack:                      # original meets the deadline
            sim.variant_counts[job.graph_name] += 1
            return
        chosen = None
        for v in graph.variants:                # ordered heavy -> light
            vt = sim.tables[v.name]
            if v.genai is not None:
                # ladder rungs differ by max_new_tokens, not layer cost:
                # estimate a full generation at the variant's cap
                est = float(vt.lat_mean[
                    np.asarray(v.worst_path(), dtype=np.int64)].sum())
            else:
                est = float(vt.lat_mean.sum())
            if est <= slack:
                chosen = v
                break
        if chosen is None:
            chosen = graph.variants[-1]          # lightest as a last resort
        sim.switch_variant(job, chosen)
        sim.variant_counts[chosen.name] = sim.variant_counts.get(chosen.name, 0) + 1

    # -------------------------------------------------------------- dispatch
    #: Scalar fast-path toggle.  The reference numpy implementation below
    #: (``schedule_reference``) stays alive as the differential-test oracle;
    #: the fast path replicates its arithmetic operation-for-operation and
    #: must stay bit-identical (see tests/test_vectorized_equiv.py).
    fast_path = True
    #: Ready-set size at which the fast path switches from the per-job
    #: scalar loop to the SoA batch arm (one (jobs, idle-accs) score matrix
    #: off the simulator's JobTable columns).  Both arms are bit-identical,
    #: so this is a pure performance knob — tests pin it to 1 to force
    #: batch coverage on small scenarios.
    soa_batch_min = 8

    def schedule(self, sim: Simulator, t: float) -> Optional[Dispatch]:
        if not self.fast_path:
            return self.schedule_reference(sim, t)
        if self.frame_drop:
            self._smart_frame_drop(sim, t)
        ready = sim.ready
        if not ready:
            return None
        idle_idx = [a.idx for a in sim.accs if not a.busy]
        if not idle_idx:
            return None
        if len(ready) == 1 and len(idle_idx) == 1:
            # forced assignment: every score is finite, so the single
            # (job, acc) pair always wins the argmax — skip the arithmetic
            job = next(iter(ready.values()))
            if self.supernet and not job.variant_locked:
                self._maybe_switch_variant(sim, job, t)
            return Dispatch(job=job, acc_idx=idle_idx[0],
                            n_layers=self._block_len(job, idle_idx[0]))
        if sim.soa is not None and len(ready) >= self.soa_batch_min:
            job, acc_idx = self._schedule_batch(sim, ready, idle_idx, t)
            if self.supernet and not job.variant_locked:
                self._maybe_switch_variant(sim, job, t)
            return Dispatch(job=job, acc_idx=acc_idx,
                            n_layers=self._block_len(job, acc_idx))
        accs = sim.accs
        prev_out = [a.prev_out_bytes for a in accs]
        prev_base = [a.prev_base for a in accs]
        alpha = self.params.alpha
        beta = self.params.beta
        best_score = -np.inf
        best: Optional[tuple[Job, int]] = None
        for job in ready.values():
            pos = job.pos
            nxt = job.path_list[pos]
            ft = _fast_table(job.table)
            # ToGo memo: pos only moves at dispatch boundaries, while the
            # reference recomputes the same pairwise numpy suffix sum on
            # every scheduling decision the job sits through
            ck = (pos, id(job.table))
            if getattr(job, "_togo_at", None) == ck:
                togo = job._togo_v                 # type: ignore[attr-defined]
            else:
                # autoregressive jobs score against the length predictor's
                # precomputed profile, never the sampled token count
                togo = (job.sched_list[pos] if job.sched_list is not None
                        else togo_seconds(job.table, job.path[pos:]))
                job._togo_at = ck                  # type: ignore[attr-defined]
                job._togo_v = togo                 # type: ignore[attr-defined]
            slack = job.deadline - t
            urgency = 0.0 if slack <= _EPS_SLACK else min(togo / slack,
                                                          URGENCY_MAX)
            lat_sum_n = ft.lat_sum[nxt]
            en_sum_n = ft.en_sum[nxt]
            in_b_n = ft.in_bytes[nxt]
            t_queue = max(t - job.t_cmpl, 0.0)
            starv = min(t_queue / ft.lat_mean[nxt], STARV_MAX)
            a_starv = alpha * starv
            base = job.base_name
            jb_score = -np.inf
            jb_acc = -1
            for ai in idle_idx:
                lat_a = ft.lat[ai][nxt]
                en_a = ft.en[ai][nxt]
                if prev_base[ai] == base:
                    cost_switch = 0.0
                else:
                    cost_switch = min(
                        (in_b_n + prev_out[ai]) * E_DRAM / en_a, CSWITCH_MAX)
                s = (urgency * (lat_sum_n / lat_a) + a_starv
                     + beta * (en_sum_n / en_a - cost_switch))
                if s > jb_score:
                    jb_score = s
                    jb_acc = ai
            if jb_score > best_score:
                best_score = jb_score
                best = (job, jb_acc)
        if best is None:
            return None
        if self.supernet and not best[0].variant_locked:
            self._maybe_switch_variant(sim, best[0], t)
        job, acc_idx = best
        return Dispatch(job=job, acc_idx=acc_idx,
                        n_layers=self._block_len(job, acc_idx))

    def _schedule_batch(self, sim: Simulator, ready: dict, idle_idx: list,
                        t: float) -> tuple[Job, int]:
        """SoA batch arm: score every (ready job, idle accelerator) pair in
        one elementwise matrix pass over the simulator's JobTable columns.

        Bit-identity with the scalar loop holds term by term: each numpy
        op is the same IEEE float64 op the scalar expression applies to the
        same value, grouped identically; and the flattened row-major
        argmax (first occurrence of the max) equals the scalar two-level
        strict-> selection — first job reaching the global max, first
        accelerator reaching that job's max."""
        soa = sim.soa
        jids = list(ready)
        rows = np.array([soa.row_of[j] for j in jids], dtype=np.intp)
        for i in np.flatnonzero(soa.cost_stale[rows]):
            sim._soa_cost_refresh(ready[jids[i]], int(rows[i]))
        k = np.array(idle_idx, dtype=np.intp)
        slack = soa.deadline[rows] - t
        tight = slack <= _EPS_SLACK
        urgency = np.where(
            tight, 0.0,
            np.minimum(soa.togo_sched[rows] / np.where(tight, 1.0, slack),
                       URGENCY_MAX))
        a_starv = self.params.alpha * np.minimum(
            np.maximum(t - soa.t_cmpl[rows], 0.0) / soa.lat_mean_n[rows],
            STARV_MAX)
        lat_g = soa.lat_n[rows[:, None], k[None, :]]
        en_g = soa.en_n[rows[:, None], k[None, :]]
        accs = sim.accs
        prev_out = np.array([accs[ai].prev_out_bytes for ai in idle_idx])
        prev_ids = np.array([accs[ai].prev_base_id for ai in idle_idx],
                            dtype=np.int64)
        cost_switch = np.where(
            soa.base_id[rows][:, None] == prev_ids[None, :],
            0.0,
            np.minimum((soa.in_b_n[rows][:, None] + prev_out[None, :])
                       * E_DRAM / en_g, CSWITCH_MAX))
        s = (urgency[:, None] * (soa.lat_sum_n[rows][:, None] / lat_g)
             + a_starv[:, None]
             + self.params.beta * (soa.en_sum_n[rows][:, None] / en_g
                                   - cost_switch))
        flat = int(np.argmax(s))
        nk = len(idle_idx)
        return ready[jids[flat // nk]], idle_idx[flat % nk]

    def schedule_reference(self, sim: Simulator, t: float) -> Optional[Dispatch]:
        """Original vector-per-job dispatch via :func:`mapscore` — retained
        as the bit-identity oracle for the scalar fast path above."""
        if self.frame_drop:
            self._smart_frame_drop(sim, t)
        ready = sim.ready_jobs()
        if not ready:
            return None
        idle = sim.idle_accs()
        if not idle:
            return None
        idle_idx = np.array([a.idx for a in idle])
        prev_out = np.array([a.prev_out_bytes for a in sim.accs])
        prev_base = [a.prev_base for a in sim.accs]
        best_score = -np.inf
        best: Optional[tuple[Job, int]] = None
        for job in ready:
            nxt = int(job.path[job.pos])
            same = np.array([pb == job.base_name for pb in prev_base])
            scores = mapscore(
                job.table, nxt, job.path[job.pos:], t, job.t_cmpl,
                job.deadline, prev_out, same, self.params,
                togo_override=(job.sched_list[job.pos]
                               if job.sched_list is not None else None),
            )[idle_idx]
            k = int(np.argmax(scores))
            if scores[k] > best_score:
                best_score = float(scores[k])
                best = (job, int(idle_idx[k]))
        if best is None:
            return None
        # Supernet switch point: decide the variant for the job that is about
        # to start, with the system load it actually faces at dispatch time.
        if self.supernet and not best[0].variant_locked:
            self._maybe_switch_variant(sim, best[0], t)
        job, acc_idx = best
        return Dispatch(job=job, acc_idx=acc_idx,
                        n_layers=self._block_len_reference(job, acc_idx))

    @staticmethod
    def _block_len(job: Job, acc_idx: int) -> int:
        """Affinity-run blocking via the fast-table row (``lat.min(axis=0)``
        over gathered columns equals a ``lat_min`` gather element-wise, so
        this matches :meth:`_block_len_reference` bit-for-bit)."""
        path = job.path_list
        pos = job.pos
        ft = _fast_table(job.table)
        row = ft.lat[acc_idx]
        lat_min = ft.lat_min
        limit = len(path) - pos
        if job.decode_len:
            # token-level preemption: a dispatch block never crosses a
            # token boundary, so between generated tokens the scheduler
            # can reassess — preempt, smart-drop, or SLO-truncate
            pl = job.prefill_len
            limit = min(limit, (pl - pos) if pos < pl
                        else job.decode_len - (pos - pl) % job.decode_len)
        n = 1
        cum = row[path[pos]]
        for i in range(1, limit):
            li = path[pos + i]
            if row[li] > PREF_TOL * lat_min[li] or cum >= BLOCK_LATENCY_S:
                break
            cum += row[li]
            n = i + 1
        return n

    @staticmethod
    def _block_len_reference(job: Job, acc_idx: int) -> int:
        """Affinity-run blocking: dispatch the run of consecutive layers
        that keep preferring this accelerator, capped at BLOCK_LATENCY_S."""
        path = job.path[job.pos:]
        lat = job.table.lat[:, path]              # (A, remaining)
        pref = lat[acc_idx] <= PREF_TOL * lat.min(axis=0)
        limit = len(path)
        if job.decode_len:
            # token-boundary cap — mirrors :meth:`_block_len` exactly
            pl, pos = job.prefill_len, job.pos
            limit = min(limit, (pl - pos) if pos < pl
                        else job.decode_len - (pos - pl) % job.decode_len)
        n, cum = 1, float(lat[acc_idx, 0])
        for i in range(1, limit):
            if not pref[i] or cum >= BLOCK_LATENCY_S:
                break
            cum += float(lat[acc_idx, i])
            n = i + 1
        return n


def dream_mapscore(seed: int = 0, **kw) -> DreamScheduler:
    return DreamScheduler(adaptivity=True, frame_drop=False, supernet=False,
                          seed=seed, **kw)


def dream_smartdrop(seed: int = 0, **kw) -> DreamScheduler:
    return DreamScheduler(adaptivity=True, frame_drop=True, supernet=False,
                          seed=seed, **kw)


def dream_full(seed: int = 0, **kw) -> DreamScheduler:
    return DreamScheduler(adaptivity=True, frame_drop=True, supernet=True,
                          seed=seed, **kw)
