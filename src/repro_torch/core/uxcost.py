"""UXCost (Algorithm 2): the paper's EDP-analogue for real-time workloads.

UXCost = (sum_m Rate_DLV[m]) * (sum_m NormEnergy[m])

  Rate_DLV[m]    — deadline-violated frames / total frames in the window,
                   floored at 1/(2*total_frames) when zero (Alg. 2 lines 7-8).
  NormEnergy[m]  — actual energy / worst-case energy, where worst case pairs
                   every executed layer with its most expensive accelerator.

Dropped frames count as violations (completion time = infinity, Section 4.2.1)
and their *would-have-run* path still contributes to the worst-case energy
normalizer, so dropping trades DLV for energy exactly as the paper describes.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelWindowStats:
    frames: int = 0
    violated: int = 0
    energy_j: float = 0.0
    worst_energy_j: float = 0.0
    #: head-to-tail pipeline latency, recorded at *tail* completions only
    #: (models with live dependents record nothing): the time from the
    #: pipeline's head frame arrival to this completion, wire/queue time
    #: included.  ``pipe_frames`` counts the recorded completions;
    #: ``pipe_latency_s`` sums their latencies (mean = sum / count).
    pipe_frames: int = 0
    pipe_latency_s: float = 0.0

    def merge(self, other: "ModelWindowStats") -> None:
        self.frames += other.frames
        self.violated += other.violated
        self.energy_j += other.energy_j
        self.worst_energy_j += other.worst_energy_j
        self.pipe_frames += other.pipe_frames
        self.pipe_latency_s += other.pipe_latency_s


@dataclass
class WindowStats:
    """Per-model statistics for one UXCost evaluation window T_exec."""

    per_model: dict[str, ModelWindowStats] = field(default_factory=dict)

    def model(self, name: str) -> ModelWindowStats:
        if name not in self.per_model:
            self.per_model[name] = ModelWindowStats()
        return self.per_model[name]

    def merge(self, other: "WindowStats") -> None:
        for name, st in other.per_model.items():
            self.model(name).merge(st)


def rate_dlv(st: ModelWindowStats) -> float:
    if st.frames == 0:
        return 0.0
    if st.violated == 0:
        return 1.0 / (2.0 * st.frames)   # Alg. 2 lines 7-8
    return st.violated / st.frames


def norm_energy(st: ModelWindowStats) -> float:
    if st.worst_energy_j <= 0.0:
        return 0.0
    return st.energy_j / st.worst_energy_j


def uxcost(stats: WindowStats) -> float:
    """Algorithm 2: overall UXCost for a window."""
    overall_dlv = sum(rate_dlv(st) for st in stats.per_model.values())
    overall_en = sum(norm_energy(st) for st in stats.per_model.values())
    return overall_dlv * overall_en


def overall_dlv_rate(stats: WindowStats) -> float:
    frames = sum(st.frames for st in stats.per_model.values())
    viol = sum(st.violated for st in stats.per_model.values())
    return viol / frames if frames else 0.0


def overall_pipeline_latency(stats: WindowStats) -> float:
    """Mean head-to-tail pipeline latency (s) over every recorded tail
    completion in the window — the end-to-end metric next to per-model
    DLV (0.0 when no pipeline completed head-to-tail)."""
    n = sum(st.pipe_frames for st in stats.per_model.values())
    total = sum(st.pipe_latency_s for st in stats.per_model.values())
    return total / n if n else 0.0


def overall_norm_energy(stats: WindowStats) -> float:
    worst = sum(st.worst_energy_j for st in stats.per_model.values())
    actual = sum(st.energy_j for st in stats.per_model.values())
    return actual / worst if worst > 0 else 0.0
