"""SLO subsystem: tiered admission control and graceful degradation
(copy of ``repro/cluster/slo.py``; its decisions are equal to the
reference's on the same inputs).

Overload is a *managed regime*, not a divergence.  Every stream carries an
:class:`SLOClass` — a service tier with a pipeline-latency budget and a
priority.  A fleet-level :class:`AdmissionController` sits in front of the
router and, from windowed telemetry plus a short-horizon load estimate,
decides for each arriving stream whether to **admit** it at full quality,
**degrade** it onto a cheaper supernet variant (the middle rung), or
**reject** it outright (a first-class outcome with its own UXCost charge —
never a silent drop).  Once streams are placed, a periodic controller tick
walks the same pressure signal through a *degradation ladder*: under
sustained pressure it swaps best-effort streams one supernet-variant level
lighter, and when pressure falls below a hysteresis band it promotes them
back.

The admission law (documented in ``docs/scheduling.md``) is a single scalar
pressure::

    P(t) = max(U(t), Uhat(t)) + w_dlv * max_n DLV_n
         + w_bklg * min(B_p90 / B0, 1) + w_lat * min(max(L/L0 - 1, 0), 1)

where ``U`` is the mean offered utilization over candidate nodes *now*,
``Uhat`` the :class:`LoadEstimator`'s short-horizon forecast (EMA level +
trend, Sparse-DySta-style: act *ahead* of saturation), ``DLV_n`` the worst
per-node deadline-violation rate of the last telemetry window, ``B_p90``
the fleet backlog p90, and ``L/L0`` the mean pipeline latency over the mean
declared budget.  Three thresholds partition the regimes::

    P < t_promote                : promote degraded streams (one level/tick)
    t_promote <= P < t_degrade   : hold (hysteresis band -- no flapping)
    t_degrade <= P < t_reject    : degrade-first (admit new non-tier-0
                                   streams one variant level down; ladder
                                   pushes placed best-effort streams deeper)
    P >= t_reject                : best-effort arrivals are rejected

Tier-0 ("guaranteed") streams are never degraded or rejected.  The
controller is deterministic — no RNG — so live decisions can be recorded as
``swap`` / ``reject`` trace records and replay bypasses it bit-exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union


class SLOError(ValueError):
    """Raised when an SLO declaration is inconsistent."""


#: Canonical tier numbers.
TIER_GUARANTEED = 0
TIER_STANDARD = 1
TIER_BEST_EFFORT = 2


@dataclass(frozen=True)
class SLOClass:
    """A service tier: latency budget (in head periods) plus priority.

    ``budget_factor`` scales the stream's head period into an end-to-end
    pipeline-latency budget (``budget_s = budget_factor / head_fps``);
    ``priority`` orders streams within a tier when the degradation ladder
    must pick victims (lower priority degrades first).
    """

    tier: int
    budget_factor: float
    priority: float

    def __post_init__(self):
        if self.tier not in TIER_DEFAULTS_SPEC:
            raise SLOError(f"unknown SLO tier {self.tier!r}; expected one of "
                           f"{sorted(TIER_DEFAULTS_SPEC)}")
        if not self.budget_factor > 0:
            raise SLOError(f"budget_factor must be positive, "
                           f"got {self.budget_factor}")
        if not self.priority > 0:
            raise SLOError(f"priority must be positive, got {self.priority}")

    def to_config(self) -> dict:
        """Minimal JSON form: a bare tier number when the tier's defaults
        apply, else the full dict (keeps trace records compact)."""
        if self == TIER_DEFAULTS[self.tier]:
            return {"tier": self.tier}
        return {"tier": self.tier, "budget_factor": self.budget_factor,
                "priority": self.priority}


#: Per-tier (budget_factor, priority) defaults; tier 1 is the legacy
#: default every pre-SLO trace and tierless stream maps onto.
TIER_DEFAULTS_SPEC = {
    TIER_GUARANTEED: (1.0, 4.0),
    TIER_STANDARD: (2.0, 2.0),
    TIER_BEST_EFFORT: (4.0, 1.0),
}
TIER_DEFAULTS = {t: SLOClass(t, bf, pr)
                 for t, (bf, pr) in TIER_DEFAULTS_SPEC.items()}
#: Legacy default: streams with no declared SLO are tier-1 "standard".
DEFAULT_SLO = TIER_DEFAULTS[TIER_STANDARD]


def slo_from_config(cfg: Union[int, dict, SLOClass, None]) -> SLOClass:
    """Normalize an SLO declaration: ``None`` -> the legacy default tier,
    a bare int -> that tier's defaults, a dict -> explicit class."""
    if cfg is None:
        return DEFAULT_SLO
    if isinstance(cfg, SLOClass):
        return cfg
    if isinstance(cfg, int) and not isinstance(cfg, bool):
        if cfg not in TIER_DEFAULTS:
            raise SLOError(f"unknown SLO tier {cfg!r}; expected one of "
                           f"{sorted(TIER_DEFAULTS)}")
        return TIER_DEFAULTS[cfg]
    if isinstance(cfg, dict):
        tier = cfg.get("tier")
        if not isinstance(tier, int) or isinstance(tier, bool):
            raise SLOError(f"SLO config needs an integer 'tier', got {cfg!r}")
        base = slo_from_config(tier)
        return SLOClass(tier=tier,
                        budget_factor=float(cfg.get("budget_factor",
                                                    base.budget_factor)),
                        priority=float(cfg.get("priority", base.priority)))
    raise SLOError(f"cannot interpret SLO declaration {cfg!r}")


class LoadEstimator:
    """Short-horizon fleet-load forecast: EMA level + EMA trend.

    Observed once per controller window with the mean offered utilization;
    ``predict()`` extrapolates ``horizon`` windows ahead so the admission
    gate reacts *before* the fleet saturates rather than after.  Purely
    deterministic (no RNG) — replay never consults it.
    """

    def __init__(self, alpha: float = 0.5, horizon: float = 2.0):
        self.alpha = float(alpha)
        self.horizon = float(horizon)
        self.level: Optional[float] = None
        self.trend = 0.0

    def observe(self, util: float) -> None:
        if self.level is None:
            self.level = float(util)
            return
        prev = self.level
        self.level = (1.0 - self.alpha) * self.level + self.alpha * float(util)
        self.trend = (1.0 - self.alpha) * self.trend \
            + self.alpha * (self.level - prev)

    def predict(self) -> float:
        if self.level is None:
            return 0.0
        return self.level + self.horizon * self.trend


@dataclass
class StreamState:
    """What the ladder needs to know about one placed stream.  ``load`` is
    the host's local pressure signal (the fleet passes the hosting node's
    window DLV rate): overload is node-local even when the admission law's
    scalar is fleet-global, so the ladder degrades victims on the hottest
    nodes first — where a swap actually relieves a pressured tier-0
    neighbour — and promotes streams on the coolest nodes first."""

    sid: int
    tier: int
    priority: float
    level: int
    max_level: int
    load: float = 0.0


class AdmissionController:
    """The fleet's SLO brain: pressure law, admission gate, ladder planner.

    Stateful but deterministic.  The host (``FleetSimulator``) feeds it one
    telemetry window per controller tick via :meth:`on_window`, asks
    :meth:`admit` at each stream arrival, and :meth:`plan` at each tick for
    degradation-ladder moves.  All thresholds are plain config so the whole
    controller round-trips through the trace meta (``to_config``) for
    provenance — replay itself applies recorded decisions and never runs
    this code.
    """

    def __init__(self, t_degrade: float = 0.85, t_reject: float = 1.05,
                 t_promote: float = 0.70, w_dlv: float = 0.5,
                 w_backlog: float = 0.25, w_latency: float = 0.5,
                 backlog_norm_s: float = 0.25, max_actions: int = 2,
                 admit_level: int = 1, alpha: float = 0.5,
                 horizon: float = 2.0):
        if not (t_promote < t_degrade <= t_reject):
            raise SLOError(
                f"thresholds must satisfy t_promote < t_degrade <= t_reject, "
                f"got {t_promote} / {t_degrade} / {t_reject}")
        self.t_degrade = float(t_degrade)
        self.t_reject = float(t_reject)
        self.t_promote = float(t_promote)
        self.w_dlv = float(w_dlv)
        self.w_backlog = float(w_backlog)
        self.w_latency = float(w_latency)
        self.backlog_norm_s = float(backlog_norm_s)
        self.max_actions = int(max_actions)
        self.admit_level = int(admit_level)
        self.estimator = LoadEstimator(alpha=alpha, horizon=horizon)
        # last-window signals (zero before the first tick: the gate runs on
        # live utilization alone until telemetry accumulates)
        self._dlv = 0.0
        self._backlog_p90 = 0.0
        self._pipe_latency_s = 0.0
        self._budgets: dict[int, float] = {}    # sid -> budget_s
        self.last_pressure = 0.0
        #: term-by-term breakdown of the last pressure evaluation
        #: (base/dlv/backlog/latency sum to last_pressure) — observability
        #: reads this to attribute every degrade/reject decision
        self.last_terms: dict[str, float] = {}
        #: optional duck-typed metrics registry
        #: (repro_torch.obs.MetricsRegistry),
        #: attached by the fleet when observability is on; publishing is
        #: observation only and never feeds back into the law
        self.metrics = None

    # ------------------------------------------------------------- config
    def to_config(self) -> dict:
        return {"t_degrade": self.t_degrade, "t_reject": self.t_reject,
                "t_promote": self.t_promote, "w_dlv": self.w_dlv,
                "w_backlog": self.w_backlog, "w_latency": self.w_latency,
                "backlog_norm_s": self.backlog_norm_s,
                "max_actions": self.max_actions,
                "admit_level": self.admit_level,
                "alpha": self.estimator.alpha,
                "horizon": self.estimator.horizon}

    @classmethod
    def make(cls, cfg: Union[bool, dict, "AdmissionController", None],
             ) -> Optional["AdmissionController"]:
        """Normalize the FleetSimulator's ``slo=`` argument: ``None``/False
        -> disabled, True -> defaults, dict -> configured, instance -> as
        given."""
        if cfg is None or cfg is False:
            return None
        if cfg is True:
            return cls()
        if isinstance(cfg, cls):
            return cfg
        if isinstance(cfg, dict):
            return cls(**cfg)
        raise SLOError(f"cannot interpret slo={cfg!r}")

    # ----------------------------------------------------------- registry
    def register(self, sid: int, slo: SLOClass, head_period_s: float) -> None:
        """Declare a stream's latency budget (called at arrival, before the
        admission verdict — rejected streams still inform the budget mean)."""
        self._budgets[sid] = slo.budget_factor * float(head_period_s)

    def forget(self, sid: int) -> None:
        self._budgets.pop(sid, None)

    def _mean_budget_s(self) -> float:
        if not self._budgets:
            return 0.0
        return sum(self._budgets.values()) / len(self._budgets)

    # ----------------------------------------------------------- pressure
    def on_window(self, window, utils: Sequence[float]) -> float:
        """Absorb one telemetry window plus the candidates' live offered
        utilizations; returns (and stashes) the updated pressure."""
        node_dlv = getattr(window, "node_dlv", None) or {}
        self._dlv = max(node_dlv.values(), default=window.dlv_rate)
        self._backlog_p90 = window.backlog_p90
        self._pipe_latency_s = window.mean_pipeline_latency_s
        u = sum(utils) / len(utils) if utils else 0.0
        self.estimator.observe(u)
        return self.pressure(utils)

    def pressure(self, utils: Sequence[float]) -> float:
        """The admission law's scalar P(t) — see the module docstring."""
        u = sum(utils) / len(utils) if utils else 0.0
        forecast = self.estimator.predict()
        p = max(u, forecast)
        base = p
        dlv_term = self.w_dlv * self._dlv
        p += dlv_term
        backlog_term = 0.0
        if self.backlog_norm_s > 0:
            backlog_term = self.w_backlog * min(
                self._backlog_p90 / self.backlog_norm_s, 1.0)
            p += backlog_term
        latency_term = 0.0
        budget = self._mean_budget_s()
        if budget > 0 and self._pipe_latency_s > 0:
            over = max(self._pipe_latency_s / budget - 1.0, 0.0)
            latency_term = self.w_latency * min(over, 1.0)
            p += latency_term
        self.last_pressure = p
        # base + dlv + backlog + latency telescopes back to P exactly;
        # util/forecast document which side the max() took
        self.last_terms = {"base": base, "util": u, "forecast": forecast,
                           "dlv": dlv_term, "backlog": backlog_term,
                           "latency": latency_term}
        if self.metrics is not None:
            self.metrics.gauge(
                "slo_pressure", "admission-law pressure P(t)").set(p)
            gt = self.metrics.gauge(
                "slo_pressure_term",
                "pressure-law term contributions (sum to slo_pressure)",
                ("term",))
            for k in ("base", "dlv", "backlog", "latency"):
                gt.set(self.last_terms[k], term=k)
        return p

    # ---------------------------------------------------------- admission
    def admit(self, slo: SLOClass, ladder_depth: int,
              utils: Sequence[float]) -> tuple[str, int]:
        """Verdict for one arriving stream: ``("admit", 0)``,
        ``("degrade", level)`` or ``("reject", 0)``.

        Tier-0 is always admitted at full quality.  Above ``t_reject``
        best-effort arrivals are rejected; between ``t_degrade`` and
        ``t_reject`` (and for non-best-effort tiers above ``t_reject``)
        arrivals with a variant ladder are admitted one level down.
        """
        p = self.pressure(utils)
        if slo.tier == TIER_GUARANTEED or p < self.t_degrade:
            return ("admit", 0)
        if p >= self.t_reject and slo.tier >= TIER_BEST_EFFORT:
            return ("reject", 0)
        if ladder_depth > 0:
            return ("degrade", min(self.admit_level, ladder_depth))
        return ("admit", 0)

    # -------------------------------------------------------------- ladder
    def plan(self, streams: Sequence[StreamState]) -> list[tuple[int, int]]:
        """Degradation-ladder moves for one controller tick: ``[(sid,
        new_level), ...]``.  Uses the pressure computed by the immediately
        preceding :meth:`on_window`.  Within the hysteresis band
        ``[t_promote, t_degrade)`` nothing moves — that band is what keeps
        the ladder from flapping.
        """
        p = self.last_pressure
        if p >= self.t_degrade:
            victims = [s for s in streams
                       if s.tier > TIER_GUARANTEED and s.level < s.max_level]
            victims.sort(key=lambda s: (-s.load, -s.tier, s.priority, s.sid))
            return [(s.sid, s.level + 1) for s in victims[:self.max_actions]]
        if p <= self.t_promote:
            lucky = [s for s in streams if s.level > 0]
            lucky.sort(key=lambda s: (s.load, s.tier, -s.priority, s.sid))
            return [(s.sid, s.level - 1) for s in lucky[:self.max_actions]]
        return []
