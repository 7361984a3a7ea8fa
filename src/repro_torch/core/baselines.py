"""Baseline schedulers evaluated against DREAM (Section 5.1).

* FCFS           — dynamic first-come-first-served at *model* granularity:
                   the oldest request goes to the first idle accelerator.
* StaticFCFS     — static scheduling (Figure 2): accelerator assignment is
                   fixed round-robin at arrival; the slot is reserved for the
                   *worst-case* path duration (static schedulers must plan for
                   the longest path of dynamic models, Section 2.2).
* VeltairLike    — models Veltair's scheduler: threshold-based layer-blocks
                   (consecutive layers grouped until a latency threshold) with
                   earliest-deadline-first job selection on the lowest-latency
                   idle accelerator. Energy-unaware.
* PlanariaLike   — models Planaria's scheduling component: deadline-aware
                   dynamic *spatial* partitioning; active jobs receive PE
                   sub-arrays proportional to their demand (ToGo/slack) and
                   run concurrently on their partitions. Energy-unaware.

Veltair targets CPU clusters and Planaria is an HW/SW co-design; per the
paper (§5.1), only their scheduling components are modeled.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .costmodel import build_cost_table, build_tables, effective_deadline
from .simulator import (_ARRIVAL_STREAM, Dispatch, Job, SchedulerBase,
                        SimResult, Simulator)
from .types import Accelerator, Scenario, SYSTEMS
from .uxcost import WindowStats, uxcost, overall_dlv_rate, overall_norm_energy


class FCFSScheduler(SchedulerBase):
    """Dynamic FCFS, model granularity (Nexus/Clockwork-style front end)."""

    name = "FCFS"

    def schedule(self, sim: Simulator, t: float) -> Optional[Dispatch]:
        ready = sim.ready_jobs()
        idle = sim.idle_accs()
        if not ready or not idle:
            return None
        job = min(ready, key=lambda j: (j.arrival, j.jid))
        return Dispatch(job=job, acc_idx=idle[0].idx,
                        n_layers=job.n_layers - job.pos)


class StaticFCFSScheduler(SchedulerBase):
    """Static scheduling for Figure 2: an offline planner bin-packs each
    *model* onto a fixed accelerator using worst-case (longest-path) latency
    estimates — a static scheduler cannot know which layers a dynamic model
    will actually run (Section 2.2) — and at runtime every frame executes on its
    model's fixed accelerator with the slot reserved for the worst-case
    duration."""

    name = "Static-FCFS"

    def __init__(self) -> None:
        self._model_acc: dict[str, int] = {}

    def _plan(self, sim: Simulator) -> None:
        """Offline worst-case bin-packing: models in decreasing worst-case
        utilization go to the accelerator with the least accumulated load."""
        util = [0.0] * len(sim.accs)
        demands = []
        for spec in sim.scenario.models:
            table = sim.tables[spec.model.name]
            worst = [float(table.lat[a].sum()) for a in range(len(sim.accs))]
            demands.append((min(worst) * spec.fps, spec.model.name, worst))
        for _, name, worst in sorted(demands, reverse=True):
            acc = min(range(len(sim.accs)),
                      key=lambda a: util[a] + worst[a])
            self._model_acc[name] = acc
            util[acc] += worst[acc]

    def on_job_created(self, sim: Simulator, job: Job) -> None:
        if not self._model_acc:
            self._plan(sim)

    def schedule(self, sim: Simulator, t: float) -> Optional[Dispatch]:
        idle = {a.idx for a in sim.idle_accs()}
        ready = sorted(sim.ready_jobs(), key=lambda j: (j.arrival, j.jid))
        for job in ready:
            acc = self._model_acc.get(job.base_name, 0)
            if acc in idle:
                return Dispatch(job=job, acc_idx=acc,
                                n_layers=job.n_layers - job.pos,
                                reserve_worst=True)
        return None


class VeltairLikeScheduler(SchedulerBase):
    """Layer-block scheduling with an EDF job order (Veltair, ASPLOS'22)."""

    name = "Veltair"

    def __init__(self, block_latency_s: float = 1.5e-3):
        self.block_latency_s = block_latency_s

    def _block_len(self, job: Job, acc_idx: int) -> int:
        lat = job.table.lat[acc_idx, job.path[job.pos:]]
        csum = np.cumsum(lat)
        n = int(np.searchsorted(csum, self.block_latency_s)) + 1
        return max(1, min(n, len(lat)))

    def schedule(self, sim: Simulator, t: float) -> Optional[Dispatch]:
        ready = sim.ready_jobs()
        idle = sim.idle_accs()
        if not ready or not idle:
            return None
        job = min(ready, key=lambda j: (j.deadline, j.jid))  # EDF
        # Veltair targets homogeneous CPU clusters (Table 5: not
        # heterogeneity-aware): any idle unit is equivalent to it, so it
        # takes the first — it never consults per-accelerator latencies.
        acc = idle[0]
        return Dispatch(job=job, acc_idx=acc.idx,
                        n_layers=self._block_len(job, acc.idx))


# ---------------------------------------------------------------------------
# Planaria-like: deadline-aware dynamic architecture fission
# ---------------------------------------------------------------------------

_SLOTS_PER_ACC = 8  # fission granularity: each accelerator splits into 8 pods


@dataclass
class _PJob:
    jid: int
    model_idx: int
    base_name: str
    path: np.ndarray
    arrival: float
    deadline: float
    worst_energy: float
    pos: int = 0
    energy_used: float = 0.0
    host_acc: int = -1
    slots: int = 0
    running: bool = False
    done: bool = False


class PlanariaSimulator:
    """Planaria's scheduling component (MICRO'20), modeled per the paper:
    deadline-aware dynamic *architecture fission*. Each accelerator can be
    split into up to ``_SLOTS_PER_ACC`` equal sub-arrays ("pods"). At every
    scheduling event (arrival / layer completion / job finish), waiting jobs
    are considered in EDF order and admitted with the *minimal* number of
    pods whose estimated remaining latency still meets the job's slack
    (Planaria: allocate just enough resources to each task to meet its
    deadline, freeing the rest for others). Jobs that cannot be feasibly
    admitted receive all remaining pods of the emptiest accelerator (best
    effort) once no feasible job is left waiting.

    Latency/energy of a layer on a k-pod partition comes from a cost table
    built for a sub-accelerator with k/8 of the PEs and the same dataflow;
    off-chip bandwidth is shared chip-wide (each full accelerator gets
    bw/n_accs; a partition gets its PE-proportional share).
    """

    name = "Planaria"

    def __init__(self, scenario: Scenario, system: str | tuple[Accelerator, ...],
                 duration_s: float = 8.0, seed: int = 0, window_s: float = 0.5,
                 stale_periods: float = 2.0):
        self.scenario = scenario
        self.system_name = system if isinstance(system, str) else "custom"
        self.accs = list(SYSTEMS[system] if isinstance(system, str) else system)
        self.duration_s = duration_s
        self.window_s = window_s
        self.stale_periods = stale_periods
        self.rng = np.random.default_rng(seed)
        # same arrival-process protocol (and dedicated rng stream) as
        # core.simulator.Simulator, so stochastic scenarios compare fairly
        self.arrival_rng = np.random.default_rng([seed, _ARRIVAL_STREAM])
        self._arrival_procs = [Simulator._materialize_arrival(s.arrival)
                               for s in scenario.models]
        self.models = {s.model.name: s.model for s in scenario.models}
        self._full_tables = build_tables(self.models, tuple(self.accs))
        self.deadlines = {
            s.model.name: effective_deadline(s.period_s,
                                             self._full_tables[s.model.name],
                                             s.deadline_s)
            for s in scenario.models
        }
        # cost tables per (model, acc_idx, n_slots)
        self._tables: dict[tuple[str, int, int], object] = {}
        self.free_slots = [int(_SLOTS_PER_ACC)] * len(self.accs)
        self.jobs: dict[int, _PJob] = {}
        self._jid = itertools.count()
        self.events: list[tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self.global_stats = WindowStats()
        self.window_stats = WindowStats()
        self.frames = 0
        self.aborts = 0

    # -- cost lookup ---------------------------------------------------
    def _table(self, model: str, acc_idx: int, slots: int):
        key = (model, acc_idx, slots)
        if key not in self._tables:
            acc = self.accs[acc_idx]
            frac = slots / _SLOTS_PER_ACC
            sub = replace(acc, pes=max(1, int(acc.pes * frac)),
                          dram_bw=acc.dram_bw * frac / len(self.accs),
                          sram_bytes=max(1, int(acc.sram_bytes * frac)))
            # the sub-accelerator table already has its bandwidth share baked
            # in, so build it standalone (shared_bw division done above)
            self._tables[key] = build_cost_table(self.models[model], (sub,),
                                                 shared_bw=False)
        return self._tables[key]

    def _remaining_latency(self, job: _PJob, acc_idx: int, slots: int) -> float:
        table = self._table(job.base_name, acc_idx, slots)
        return float(table.lat[0, job.path[job.pos:]].sum())

    # -- job lifecycle ---------------------------------------------------
    def _push(self, t: float, kind: int, arg) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, arg))

    def _create_job(self, model_idx: int, t: float) -> None:
        spec = self.scenario.models[model_idx]
        graph = spec.model
        path = np.asarray(graph.sample_path(self.rng), dtype=np.int64)
        full = self._full_tables[graph.name]
        job = _PJob(
            jid=next(self._jid), model_idx=model_idx, base_name=graph.name,
            path=path, arrival=t, deadline=t + self.deadlines[graph.name],
            worst_energy=float(full.en_max[path].sum()),
        )
        self.jobs[job.jid] = job

    def _finish(self, job: _PJob, t: float, dropped: bool) -> None:
        job.done = True
        if job.slots and job.host_acc >= 0:
            self.free_slots[job.host_acc] += job.slots
            job.slots = 0
        self.jobs.pop(job.jid, None)
        st = self.window_stats.model(job.base_name)
        st.frames += 1
        st.violated += int(dropped or t > job.deadline)
        st.energy_j += job.energy_used
        st.worst_energy_j += job.worst_energy
        self.frames += 1
        if not dropped:
            for dep in self.scenario.dependents_of(job.base_name):
                spec = self.scenario.models[dep]
                if self.rng.random() < spec.trigger_prob:
                    self._create_job(dep, t)

    # -- scheduling -------------------------------------------------------
    def _allocate(self, t: float) -> None:
        """EDF admission with minimal-feasible fission allocation."""
        waiting = sorted((j for j in self.jobs.values()
                          if not j.running and not j.done),
                         key=lambda j: (j.deadline, j.jid))
        for job in waiting:
            slack = job.deadline - t
            best: tuple[int, int] | None = None  # (acc, slots)
            # minimal feasible partition across accelerators
            for acc_idx in range(len(self.accs)):
                for slots in range(1, self.free_slots[acc_idx] + 1):
                    if self._remaining_latency(job, acc_idx, slots) <= slack:
                        if best is None or slots < best[1]:
                            best = (acc_idx, slots)
                        break
            if best is None:
                # infeasible: best effort — all pods of the emptiest acc
                acc_idx = int(np.argmax(self.free_slots))
                if self.free_slots[acc_idx] == 0:
                    continue
                best = (acc_idx, self.free_slots[acc_idx])
            acc_idx, slots = best
            self.free_slots[acc_idx] -= slots
            job.host_acc, job.slots, job.running = acc_idx, slots, True
            self._start_layer(job, t)

    def _start_layer(self, job: _PJob, t: float) -> None:
        table = self._table(job.base_name, job.host_acc, job.slots)
        layer = int(job.path[job.pos])
        dur = float(table.lat[0, layer])
        job.energy_used += float(table.en[0, layer])
        self._push(t + dur, 1, job.jid)

    def _on_layer_done(self, jid: int, t: float) -> None:
        job = self.jobs.get(jid)
        if job is None or job.done:
            return
        job.pos += 1
        if job.pos >= len(job.path):
            self._finish(job, t, dropped=False)
            return
        # layer boundary: release the partition so EDF can re-fission
        self.free_slots[job.host_acc] += job.slots
        job.slots, job.running = 0, False

    def _abort_stale(self, t: float) -> None:
        for j in list(self.jobs.values()):
            period = self.scenario.models[j.model_idx].period_s
            if not j.running and j.pos == 0 and \
                    t > j.deadline + self.stale_periods * period:
                self.aborts += 1
                self._finish(j, t, dropped=True)

    def run(self) -> SimResult:
        for i, spec in enumerate(self.scenario.models):
            if spec.depends_on is None:
                first = self._arrival_procs[i].start(i, spec.period_s,
                                                     self.arrival_rng)
                if first is not None:
                    self._push(first, 0, i)
        self._push(self.window_s, 2, None)
        t = 0.0
        while self.events:
            t, _, kind, arg = heapq.heappop(self.events)
            if t > self.duration_s:
                break
            if kind == 0:
                idx = int(arg)
                self._create_job(idx, t)
                spec = self.scenario.models[idx]
                nxt = self._arrival_procs[idx].next_after(
                    t, spec.period_s, self.arrival_rng)
                if nxt is not None:
                    self._push(nxt, 0, idx)
            elif kind == 1:
                self._on_layer_done(int(arg), t)
            else:
                self.global_stats.merge(self.window_stats)
                self.window_stats = WindowStats()
                self._push(t + self.window_s, 2, None)
            self._abort_stale(t)
            self._allocate(t)
        self.global_stats.merge(self.window_stats)
        return SimResult(
            scenario=self.scenario.name, system=self.system_name,
            scheduler=self.name, duration_s=self.duration_s,
            stats=self.global_stats, uxcost=uxcost(self.global_stats),
            dlv_rate=overall_dlv_rate(self.global_stats),
            norm_energy=overall_norm_energy(self.global_stats),
            frames=self.frames, drops=0, aborts=self.aborts,
            variant_counts={}, windows=[], acc_utilization=[],
        )


def run_planaria(scenario: Scenario, system: str, duration_s: float = 8.0,
                 seed: int = 0, **kw) -> SimResult:
    return PlanariaSimulator(scenario, system, duration_s=duration_s,
                             seed=seed, **kw).run()
