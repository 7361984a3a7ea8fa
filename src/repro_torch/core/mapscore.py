"""MapScore (Algorithm 1 of the paper), vectorized over accelerators.

MapScore(tsk, acc) = Score_Urgency(tsk) * Score_LatPref(tsk, acc)
                     + alpha * Score_Starv(tsk)
                     + beta  * Score_Energy(tsk, acc)

with  Score_Urgency = ToGo / Slack
      Score_LatPref = sum_i EstLat(next, i) / EstLat(next, acc)
      Score_Starv   = T_queue / mean_i EstLat(next, i)
      Score_Energy  = Pref_Energy - Cost_switch
      Pref_Energy   = sum_i EstEn(next, i) / EstEn(next, acc)
      Cost_switch   = CswitchEnergy(tsk, acc.prevTask, acc) / EstEn(next, acc)

All Est* terms come from the offline cost tables (costmodel.CostTable).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .costmodel import CostTable, E_DRAM

_EPS_SLACK = 1e-6
#: Numerical-stability clamps. Alg. 1's raw terms are unbounded ratios:
#: Urgency = ToGo/Slack explodes as Slack -> 0+, Starv = T_queue/lat blows up
#: for microsecond layers that waited milliseconds, and Cost_switch can be
#: orders of magnitude above Pref_Energy when the incoming layer is tiny.
#: The paper constrains alpha, beta to [0, 2] (Section 5.2), which implies
#: comparably-scaled score terms; clamping each term to the same O(10) range
#: realizes that — and makes the (alpha, beta) UXCost landscape the smooth,
#: well-conditioned surface of the paper's Figure 3 rather than a cliff
#: where one runaway term dictates every decision.
URGENCY_MAX = 20.0
STARV_MAX = 20.0
CSWITCH_MAX = 10.0


@dataclass
class MapScoreParams:
    alpha: float = 1.0  # starvation factor  (range [0, 2], Section 5.2)
    beta: float = 1.0   # energy factor      (range [0, 2])


def togo_seconds(table: CostTable, remaining: np.ndarray) -> float:
    """ToGo(tsk): predicted remaining time, averaged across accelerators
    (Alg. 1 line 2). `remaining` = layer indices still in the task's queue."""
    if remaining.size == 0:
        return 0.0
    return float(table.lat_mean[remaining].sum())


def min_togo_seconds(table: CostTable, remaining: np.ndarray) -> float:
    """minimum_to_go for the smart frame drop (best accelerator per layer,
    no context switches) — Section 4.2.1, condition 1."""
    if remaining.size == 0:
        return 0.0
    return float(table.lat_min[remaining].sum())


def mapscore(
    table: CostTable,
    next_layer: int,
    remaining: np.ndarray,
    t_curr: float,
    t_cmpl: float,
    deadline: float,
    prev_out_bytes: np.ndarray,
    same_model: np.ndarray,
    params: MapScoreParams,
    togo_override: float | None = None,
) -> np.ndarray:
    """MapScore of one task on *all* accelerators (vector of length n_accs).

    prev_out_bytes[a] — activation bytes of the job last run on accelerator a
                        (0 if none); drives the context-switch energy.
    same_model[a]     — True if accelerator a last ran this very model (no
                        context switch needed).
    togo_override     — predicted remaining seconds replacing the true-path
                        ToGo (autoregressive jobs: the scheduler sees the
                        length *predictor*, not the sampled token count).
    """
    lat_next = table.lat[:, next_layer]          # (A,)
    en_next = table.en[:, next_layer]            # (A,)

    togo = (togo_seconds(table, remaining) if togo_override is None
            else togo_override)
    slack = deadline - t_curr
    if slack <= _EPS_SLACK:
        urgency = 0.0                            # hopeless frame: deprioritize
    else:
        urgency = min(togo / slack, URGENCY_MAX)  # line 7 (clamped)

    latpref = table.lat_sum[next_layer] / lat_next   # line 8

    t_queue = max(t_curr - t_cmpl, 0.0)
    starv = min(t_queue / table.lat_mean[next_layer], STARV_MAX)  # line 9

    # context-switch energy: fetch new activation + flush old one (line 10)
    cswitch_j = (table.in_bytes[next_layer] + prev_out_bytes) * E_DRAM
    cswitch_j = np.where(same_model, 0.0, cswitch_j)
    cost_switch = np.minimum(cswitch_j / en_next, CSWITCH_MAX)

    pref_energy = table.en_sum[next_layer] / en_next  # line 11
    score_energy = pref_energy - cost_switch          # lines 12-13

    return urgency * latpref + params.alpha * starv + params.beta * score_energy
