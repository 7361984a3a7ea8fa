"""Parameter-probe search engines — the adaptivity core of Section 3.6
(copy of ``repro/core/adaptivity.py``; the same seeds give the same
candidates, centers and commits).

Three hosts share the same idea (perturb a parameter vector, measure one
candidate per feedback window, commit, shrink):

  * the per-node online engine (``scheduler.AdaptivityState``) probes
    (alpha, beta) against live UXCost windows — it subclasses
    :class:`ProbeSearch`, the host-agnostic N-dimensional star probe;
  * the fleet weight tuner (``repro_torch.cluster.router.TunedScoreRouter``)
    probes the routing score weights against fleet telemetry windows with
    :class:`CoordinateProbe`, a seeded coordinate search whose best-wins
    commit rule tolerates the noisier fleet-level signal;
  * the *offline* variant (:func:`optimize_params`) used to study
    convergence: each candidate is evaluated by a full (short) simulation
    and the trajectory is recorded, then compared against a grid-search
    global optimum over the constrained space [0, 2]^2.

Both online probes are plain state machines over ``step(cost, rng)`` —
no simulator, scheduler, or fleet types — which is what lets one module
serve hosts at two different system layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

PARAM_LO, PARAM_HI = 0.0, 2.0


@dataclass
class ProbeSearch:
    """Radius-shrinking *star* probe over an N-dimensional box.

    The online analogue of :func:`optimize_params`: candidates are the
    current center, its axis neighbors at the current radius, and one
    distant random sample; each call to :meth:`step` records the cost the
    live candidate just achieved and returns the candidate to deploy for
    the next feedback window.  When every candidate is measured the center
    moves to the inverse-cost-weighted interpolation of the two best and
    the radius shrinks; below ``r_min`` the probe parks at the center.

    Hosts: ``scheduler.AdaptivityState`` layers per-node
    DLV-drift re-triggering on top; the fleet layer re-arms explicitly via
    :meth:`retrigger` on membership churn and phase events.
    """

    center: np.ndarray
    radius: float = 0.5
    r_min: float = 0.05
    shrink: float = 0.6
    probing: bool = True
    candidates: list[np.ndarray] = field(default_factory=list)
    results: list[tuple[float, np.ndarray]] = field(default_factory=list)
    cand_idx: int = 0
    lo: float = PARAM_LO
    hi: float = PARAM_HI

    def _make_candidates(self, rng: np.random.Generator) -> None:
        n = len(self.center)
        dirs = []
        for i in range(n):
            e = np.zeros(n)
            e[i] = 1.0
            dirs += [e, -e]
        cands = [self.center.copy()]
        cands += [np.clip(self.center + self.radius * d, self.lo, self.hi)
                  for d in dirs]
        # one distant sample (the paper samples neighboring *and* distant
        # pairs)
        cands.append(rng.uniform(self.lo, self.hi, size=n))
        self.candidates = cands
        self.results = []
        self.cand_idx = 0

    def current(self) -> np.ndarray:
        if self.probing and self.candidates:
            return self.candidates[self.cand_idx]
        return self.center

    def retrigger(self, radius: float = 0.4) -> None:
        """Restart the probe from the current center — the response to an
        externally-signalled workload change (stream migration, node
        membership churn, phase event) rather than a detected drift.
        Fresh candidates are drawn on the next step."""
        self.radius = max(self.radius, radius)
        self.probing = True
        self.candidates = []
        self.results = []
        self.cand_idx = 0

    def _on_stop(self) -> None:
        """Hook: the probe just parked (radius fell below ``r_min``)."""

    def step(self, cost: float, rng: np.random.Generator) -> np.ndarray:
        """Record ``cost`` for the live candidate; return the parameters to
        deploy for the next feedback window."""
        if not self.probing:
            return self.center
        if not self.candidates:
            self._make_candidates(rng)
            return self.candidates[0]
        self.results.append((cost, self.candidates[self.cand_idx].copy()))
        self.cand_idx += 1
        if self.cand_idx < len(self.candidates):
            return self.candidates[self.cand_idx]
        # all candidates measured: interpolate between the two best
        self.results.sort(key=lambda r: r[0])
        (u1, p1), (u2, p2) = self.results[0], self.results[1]
        w1, w2 = 1.0 / (u1 + 1e-9), 1.0 / (u2 + 1e-9)
        self.center = np.clip((w1 * p1 + w2 * p2) / (w1 + w2),
                              self.lo, self.hi)
        self.radius *= self.shrink
        if self.radius < self.r_min:
            self.probing = False
            self.candidates = []
            self._on_stop()
            return self.center
        self._make_candidates(rng)
        return self.candidates[0]


@dataclass
class CoordinateProbe:
    """Seeded coordinate search with a best-wins commit rule.

    The fleet-scale analogue of :class:`ProbeSearch`, shaped by two fleet
    realities: feedback windows are *scarce* (a run sees tens, not
    hundreds), and window costs are noisy (the offered load itself drifts
    between windows).  So instead of measuring a full star of 2N+2
    candidates before committing, the probe perturbs **one coordinate at a
    time** — candidates are [center, center + r·span·e_a, center −
    r·span·e_a] — and commits the *best measured candidate* (which may be
    the center itself, bounding the damage a noisy window can do to at
    most one probing window).  After a full pass over ``axis_order`` the
    radius shrinks and one distant seeded sample joins the next pass's
    first mini-cycle, the escape hatch the paper's distant draws provide.

    ``lo``/``hi`` are per-dimension bounds; the probing step along axis
    ``a`` is ``radius * (hi[a] − lo[a]) / 2``, so one radius spans
    heterogeneous weight scales.  Deterministic given the ``rng`` handed
    to :meth:`step`.  Hosts re-arm via :meth:`retrigger` (membership
    churn, phase events) exactly like the per-node probe.
    """

    center: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    radius: float = 0.5
    r_min: float = 0.08
    shrink: float = 0.7
    #: relative commit margin: a candidate only displaces the center when
    #: its measured cost beats the center's *same-cycle* measurement by
    #: more than this fraction.  Feedback windows are noisy (the workload
    #: itself drifts between them) and a wrong commit persists until
    #: re-probed, while a missed commit merely keeps the status quo — so
    #: the asymmetric risk warrants a deadband.
    margin: float = 0.0
    axis_order: Optional[Sequence[int]] = None
    probing: bool = True
    pass_pos: int = 0                 # position within the current pass
    fresh_pass: bool = False          # add a distant sample this mini-cycle
    candidates: list[np.ndarray] = field(default_factory=list)
    results: list[tuple[float, np.ndarray]] = field(default_factory=list)
    cand_idx: int = 0
    commits: int = 0                  # mini-cycles that moved the center
    steps: int = 0                    # measured windows consumed
    retriggers: int = 0

    def __post_init__(self) -> None:
        self.center = np.asarray(self.center, dtype=np.float64)
        self.lo = np.asarray(self.lo, dtype=np.float64)
        self.hi = np.asarray(self.hi, dtype=np.float64)
        if self.axis_order is None:
            self.axis_order = tuple(range(len(self.center)))
        self.axis_order = tuple(int(a) for a in self.axis_order)

    @property
    def axis(self) -> int:
        """The coordinate the current (or next) mini-cycle perturbs."""
        return self.axis_order[self.pass_pos]

    def _clip(self, p: np.ndarray) -> np.ndarray:
        return np.clip(p, self.lo, self.hi)

    def _make_candidates(self, rng: np.random.Generator) -> None:
        a = self.axis
        step = self.radius * (self.hi[a] - self.lo[a]) / 2.0
        e = np.zeros(len(self.center))
        e[a] = 1.0
        cands = [self.center.copy(),
                 self._clip(self.center + step * e),
                 self._clip(self.center - step * e)]
        if self.fresh_pass:
            cands.append(rng.uniform(self.lo, self.hi))
            self.fresh_pass = False
        # a center pinned at a bound clips a neighbor onto itself — drop
        # the duplicate rather than spend a scarce window re-measuring it
        dedup: list[np.ndarray] = []
        for c in cands:
            if not any(np.array_equal(c, d) for d in dedup):
                dedup.append(c)
        self.candidates = dedup
        self.results = []
        self.cand_idx = 0

    def current(self) -> np.ndarray:
        if self.probing and self.candidates:
            return self.candidates[self.cand_idx]
        return self.center

    def retrigger(self, radius: float = 0.4) -> None:
        """Re-arm after an externally-signalled workload change: widen the
        radius, restart the pass, and re-earn the distant sample."""
        self.radius = max(self.radius, radius)
        self.probing = True
        self.pass_pos = 0
        self.fresh_pass = True
        self.candidates = []
        self.results = []
        self.cand_idx = 0
        self.retriggers += 1

    def step(self, cost: float, rng: np.random.Generator) -> np.ndarray:
        """Record ``cost`` for the live candidate; return the point to
        deploy for the next feedback window."""
        if not self.probing:
            return self.center
        self.steps += 1
        if not self.candidates:
            self._make_candidates(rng)
            return self.candidates[0]
        self.results.append((cost, self.candidates[self.cand_idx].copy()))
        self.cand_idx += 1
        if self.cand_idx < len(self.candidates):
            return self.candidates[self.cand_idx]
        self._commit_and_advance()
        if not self.probing:
            return self.center
        self._make_candidates(rng)
        return self.candidates[0]

    def _commit_and_advance(self) -> None:
        """Mini-cycle complete: best-wins commit, gated by the relative
        margin against the center's own measurement this cycle (the center
        is always candidate 0, so ``results[0]`` is its cost); then advance
        the pass, shrinking the radius after a full one."""
        center_cost = self.results[0][0]
        best_cost, best = min(self.results, key=lambda r: r[0])
        if (not np.array_equal(best, self.center)
                and best_cost < center_cost * (1.0 - self.margin)):
            self.center = best
            self.commits += 1
        self.candidates = []
        self.pass_pos += 1
        if self.pass_pos >= len(self.axis_order):
            self.pass_pos = 0
            self.fresh_pass = True
            self.radius *= self.shrink
            if self.radius < self.r_min:
                self.probing = False

    def step_batch(self, cost_fn: Callable[[np.ndarray], float],
                   rng: np.random.Generator) -> np.ndarray:
        """One feedback window where *all* of the mini-cycle's candidates
        can be scored on the same data (``cost_fn(point) -> cost``): score
        the center and its axis neighbors (plus the pass's distant
        sample), apply the margin-gated best-wins commit, advance the
        pass, and return the new center.

        This is the *hindsight* mode: a host that can re-score recorded
        decisions under counterfactual parameters (e.g. the fleet router
        re-picking nodes for the window's placements against realized
        node outcomes) gets a whole mini-cycle out of every window — and,
        unlike the deploy-and-measure :meth:`step`, never exposes the
        system to an untested candidate.  One commit opportunity per
        window instead of one measurement per window."""
        if not self.probing:
            return self.center
        self.steps += 1
        self._make_candidates(rng)
        self.results = [(float(cost_fn(c)), c.copy())
                        for c in self.candidates]
        self._commit_and_advance()
        return self.center


@dataclass
class SearchTrace:
    points: list[tuple[float, float]] = field(default_factory=list)
    costs: list[float] = field(default_factory=list)
    evals: int = 0

    @property
    def best(self) -> tuple[tuple[float, float], float]:
        k = int(np.argmin(self.costs))
        return self.points[k], self.costs[k]


def optimize_params(
    eval_fn: Callable[[float, float], float],
    init: tuple[float, float] | None = None,
    radius: float = 1.0,
    shrink: float = 0.6,
    r_min: float = 0.05,
    seed: int = 0,
) -> SearchTrace:
    """Radius-shrinking interpolation search (Section 3.6).

    Per step: evaluate the center, eight neighbors at the current radius
    (axis + diagonal — the paper samples "neighboring pairs") and one
    distant random sample; move to the inverse-cost-weighted interpolation
    of the two best; shrink the radius; stop below `r_min`. The initial
    radius spans half the [0, 2]^2 space so a cold (IDLE) start can reach
    any basin; warm starts (workload switches) converge in the first steps.
    """
    rng = np.random.default_rng(seed)
    center = np.asarray(init if init is not None else
                        rng.uniform(PARAM_LO, PARAM_HI, 2), dtype=np.float64)
    trace = SearchTrace()
    cache: dict[tuple[float, float], float] = {}

    def ev(p: np.ndarray) -> float:
        key = (round(float(p[0]), 6), round(float(p[1]), 6))
        if key not in cache:
            cache[key] = float(eval_fn(*key))
            trace.evals += 1
        return cache[key]

    trace.points.append((float(center[0]), float(center[1])))
    trace.costs.append(ev(center))
    r = radius
    d = 0.7071
    dirs = np.array([(1, 0), (-1, 0), (0, 1), (0, -1),
                     (d, d), (d, -d), (-d, d), (-d, -d)], dtype=np.float64)
    while r >= r_min:
        cands = [center] + [np.clip(center + r * dd, PARAM_LO, PARAM_HI)
                            for dd in dirs]
        cands.append(rng.uniform(PARAM_LO, PARAM_HI, 2))
        scored = sorted(((ev(c), tuple(c)) for c in cands), key=lambda x: x[0])
        (u1, p1), (u2, p2) = scored[0], scored[1]
        w1, w2 = 1.0 / (u1 + 1e-9), 1.0 / (u2 + 1e-9)
        center = np.clip(
            (w1 * np.asarray(p1) + w2 * np.asarray(p2)) / (w1 + w2),
            PARAM_LO, PARAM_HI,
        )
        trace.points.append((float(center[0]), float(center[1])))
        trace.costs.append(ev(center))
        r *= shrink
    return trace


def grid_search(
    eval_fn: Callable[[float, float], float], n: int = 9
) -> tuple[tuple[float, float], float, np.ndarray]:
    """Brute-force global optimum over [0,2]^2 (the Figure-3 heat map)."""
    xs = np.linspace(PARAM_LO, PARAM_HI, n)
    grid = np.empty((n, n))
    best, best_p = np.inf, (0.0, 0.0)
    for i, a in enumerate(xs):
        for j, b in enumerate(xs):
            c = float(eval_fn(float(a), float(b)))
            grid[i, j] = c
            if c < best:
                best, best_p = c, (float(a), float(b))
    return best_p, best, grid
