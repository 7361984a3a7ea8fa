"""MapScore's tunable weights (copy of the JAX package's ``MapScoreParams``).

The serving engine computes MapScore itself from its measured latency
table; only the (alpha, beta) pair is shared with the simulator's
vectorised MapScore, which the port does not need.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MapScoreParams:
    alpha: float = 1.0  # starvation factor  (range [0, 2], Section 5.2)
    beta: float = 1.0   # energy factor      (range [0, 2])
