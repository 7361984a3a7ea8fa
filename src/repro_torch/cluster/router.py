"""Global admission/routing policies: which node serves a new stream, and —
when stage splitting is enabled — which node serves each *stage* of it
(copy of ``repro/cluster/router.py``; placements, scores and tuned weights
are bit-equal to the reference's on the same inputs).

The router sees only aggregated telemetry (:class:`~.node.NodeTelemetry`)
plus per-(stream, node) cost summaries — offline tables in the fleet
simulator, measured latency tables over live serving engines — never
per-job state, so the same policies run a real deployment where nodes
export a handful of gauges. A node is anything that satisfies
:class:`~.node.RoutableNode`: ``node_id`` and ``telemetry()``. A stream
gives its cost on a node through ``cost_on(node)``; stage placement also
reads ``n_stages``, ``stage_cost_on``, ``parent_of``, ``act_bytes_into``
and ``stage_period_s``, and budget-aware scoring an optional
``budget_factor``.

Policies:

  * ``round_robin``   — cycle over live nodes; the fleet baseline.
  * ``least_loaded``  — minimize post-placement offered utilization.
  * ``score``         — DREAM-Fleet: a MapScore-analogue at node granularity
    combining load, hardware preference (how well the stream's models suit
    the node's WS/OS accelerator mix, weighted by deadline urgency) and the
    node's recent UXCost-window health.
  * ``tuned_score``   — the same score with weights *learned online*: a
    coordinate probe over weight multipliers, fed by fleet telemetry
    windows (see ``repro_torch.cluster.telemetry``), re-armed on membership
    churn and phase events — the paper's tunable-parameter adaptivity
    lifted to the fleet layer.

Stage-level placement (``place_stages``) splits a cascade pipeline across
nodes: the score policy places stages greedily in pipeline order, charging
a transfer-cost penalty (activation bytes over the inter-node link, from
the reference's ``TransferModel``; any object with ``enabled`` and
``transfer_s(bytes)``) whenever a cascade edge would
cross nodes.  With zero bandwidth the penalty is infinite and placement
degenerates to whole-pipeline.  Policies without stage awareness co-locate
every stage on the whole-stream choice.

All policies are deterministic: ties break on node id, and the round-robin
cursor is part of the policy state (reconstructed identically on replay —
though replay short-circuits routing entirely via recorded placements).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.adaptivity import CoordinateProbe
from .node import RoutableNode, StreamCost


def argmin_node(nodes: Sequence[RoutableNode], score_fn) -> int:
    """Node id minimizing ``score_fn(node)``, ties to the lower node id —
    the one argmin loop every placement path shares."""
    best_id, best_key = nodes[0].node_id, None
    for node in nodes:
        key = (score_fn(node), node.node_id)
        if best_key is None or key < best_key:
            best_id, best_key = node.node_id, key
    return best_id


class _BatchInputs:
    """Per-node cost/telemetry columns for one placement decision, gathered
    in candidate order.  One Python pass over the nodes fills the columns;
    everything downstream (terms, scores, argmin) is a handful of (N,)
    numpy ops regardless of fleet size.  Values are the exact same floats
    the scalar path reads — ``cost_on``/``telemetry`` are memoized, so the
    gather is dict lookups, not recomputation."""

    __slots__ = ("ids", "iso", "offered", "urgency", "offered_util",
                 "n_accs", "backlog", "dlv", "bf")

    def __init__(self, stream, nodes: Sequence[RoutableNode],
                 stage: Optional[int] = None):
        self.bf = getattr(stream, "budget_factor", 1.0)
        cols = getattr(nodes, "tel_columns", None)
        if cols is not None:
            # fleet-maintained SoA columns: telemetry rows are already
            # flat arrays (dirty-refreshed from the same memoized
            # telemetry() snapshots), and cost columns fill with ONE
            # cost_on per distinct accelerator mix via the system groups
            c = cols()
            n = len(nodes)
            self.ids = c["ids"]
            self.offered_util = c["offered_util"]
            self.n_accs = c["n_accs"]
            self.backlog = c["backlog"]
            self.dlv = c["dlv"]
            self.iso = np.empty(n)
            self.offered = np.empty(n)
            self.urgency = np.empty(n)
            for node, ix in c["groups"]:
                sc = (stream.cost_on(node) if stage is None
                      else stream.stage_cost_on(node, stage))
                self.iso[ix] = sc.iso_s
                self.offered[ix] = sc.offered_s
                self.urgency[ix] = sc.urgency
            return
        # costs depend only on the node's accelerator mix: resolve each
        # distinct system once, then map nodes onto the shared StreamCost
        # (the exact objects the scalar path's memoized cost_on returns)
        cost_of: dict = {}
        costs = []
        for node in nodes:
            # a node without a named system (a serving-engine adapter) is
            # its own group, as a "custom" fleet node is
            system = getattr(node, "system", "custom")
            key = system if system != "custom" else ("node", node.node_id)
            c = cost_of.get(key)
            if c is None:
                c = (stream.cost_on(node) if stage is None
                     else stream.stage_cost_on(node, stage))
                cost_of[key] = c
            costs.append(c)
        tels = [node.telemetry() for node in nodes]
        self.ids = np.array([node.node_id for node in nodes], dtype=np.int64)
        self.iso = np.array([c.iso_s for c in costs])
        self.offered = np.array([c.offered_s for c in costs])
        self.urgency = np.array([c.urgency for c in costs])
        self.offered_util = np.array([t.offered_util for t in tels])
        self.n_accs = np.array([float(t.n_accs) for t in tels])
        self.backlog = np.array([t.backlog_s for t in tels])
        self.dlv = np.array([t.window_dlv for t in tels])

    def best_iso(self) -> float:
        """``min`` over the iso column — bit-equal to the scalar genexpr
        ``min(stream.cost_on(n).iso_s for n in nodes)`` (min is exact)."""
        return float(self.iso.min())


class RouterPolicy:
    """Placement policy plug-in: pick a node id for a candidate stream."""

    name = "base"
    #: whether place_stages may put stages of one stream on different
    #: nodes; non-splitting policies also migrate and rebalance streams as
    #: co-located units
    splits_stages = False

    def place(self, stream, nodes: Sequence[RoutableNode]) -> int:
        """Return the node_id to host ``stream`` (a StreamView).  ``nodes``
        is the list of live, non-draining nodes, sorted by node_id."""
        raise NotImplementedError

    def place_stages(self, stream, nodes: Sequence[RoutableNode],
                     transfer) -> list[int]:
        """Per-stage placement: node_id for each pipeline stage of
        ``stream`` (a StreamView), head first.  The default co-locates all
        stages on the whole-stream ``place`` choice; stage-aware policies
        override to split cascades when the transfer economics justify it."""
        del transfer
        return [self.place(stream, nodes)] * stream.n_stages


class RoundRobinRouter(RouterPolicy):
    name = "round_robin"

    def __init__(self) -> None:
        self._cursor = 0

    def place(self, stream, nodes: Sequence[RoutableNode]) -> int:
        node = nodes[self._cursor % len(nodes)]
        self._cursor += 1
        return node.node_id


class LeastLoadedRouter(RouterPolicy):
    """Minimize the node's offered utilization after placement."""

    name = "least_loaded"

    def place(self, stream, nodes: Sequence[RoutableNode]) -> int:
        best_id, best_key = nodes[0].node_id, None
        for node in nodes:
            tel = node.telemetry()
            cost = stream.cost_on(node)
            after = tel.offered_util + cost.offered_s / tel.n_accs
            key = (after, tel.queue_depth, node.node_id)
            if best_key is None or key < best_key:
                best_id, best_key = node.node_id, key
        return best_id


#: DREAM-Fleet score weights.  Load dominates (an overloaded node violates
#: deadlines no matter how well-matched its dataflows are); the live
#: backlog corrects the static offered-load estimate with what is actually
#: queued; preference is urgency-weighted (tight-deadline streams pay most
#: for a poor hardware match); recent deadline-violation health breaks
#: structural ties toward nodes that are currently delivering.
W_BACKLOG = 0.5
W_PREF = 0.2
W_UX = 0.15
URGENCY_CAP = 4.0
#: weight of the cross-node transfer penalty in stage-level scoring: the
#: per-trigger link time as a fraction of the receiving stage's period,
#: amplified so the router only splits when the hardware-match gain is
#: decisively larger than the wire bill
W_XFER = 8.0

#: the routing weight vector, in canonical order.  ``load`` multiplies the
#: post-placement offered utilization (1.0 statically — the term every
#: other weight is expressed relative to); the rest are the hand-fixed
#: constants above.  ``TunedScoreRouter`` learns multipliers on this
#: vector online from fleet telemetry.
WEIGHT_NAMES = ("load", "backlog", "pref", "ux", "xfer")
STATIC_WEIGHTS = (1.0, W_BACKLOG, W_PREF, W_UX, W_XFER)


class ScoreDrivenRouter(RouterPolicy):
    name = "score"
    splits_stages = True
    #: batched-scoring toggle.  True evaluates all candidate nodes as (N,)
    #: numpy column ops (one gather pass + one argmin); False runs the
    #: original per-node scalar loops, kept alive as the bit-identity
    #: oracle for tests/test_vectorized_equiv.py.  The two paths replicate
    #: each other's float expressions operation-for-operation (the score
    #: is an explicit elementwise weight chain, never a dot product, and
    #: ``np.argmin``'s first-occurrence rule equals the scalar
    #: ``(score, node_id)`` tie-break because candidates arrive sorted by
    #: node id), so flipping the flag never changes a placement.
    vectorized = True
    #: SLO-budget-aware preference weighting.  When on, the urgency that
    #: multiplies the hardware-match penalty is divided by the stream's
    #: declared pipeline-latency budget (in head periods, from its SLO
    #: tier): a best-effort stream with a 4-period budget tolerates a
    #: mediocre hardware match four times as well as a guaranteed-tier
    #: one, so the preference term stops overruling load balance on its
    #: behalf.  Off by default — dividing by the neutral 1.0 factor is
    #: bit-exact, so every recorded trace predating the flag replays
    #: unchanged.
    budget_aware = False

    def __init__(self) -> None:
        (self.w_load, self.w_backlog, self.w_pref, self.w_ux,
         self.w_xfer) = STATIC_WEIGHTS

    @property
    def weights(self) -> tuple[float, ...]:
        """The live weight vector, in ``WEIGHT_NAMES`` order."""
        return (self.w_load, self.w_backlog, self.w_pref, self.w_ux,
                self.w_xfer)

    def set_weights(self, weights: Sequence[float]) -> None:
        """Install a full weight vector (``WEIGHT_NAMES`` order).  Replay
        applies recorded tuner decisions through this, bypassing the tuner."""
        w = [float(x) for x in weights]
        if len(w) != len(WEIGHT_NAMES):
            raise ValueError(f"expected {len(WEIGHT_NAMES)} weights "
                             f"{WEIGHT_NAMES}, got {len(w)}")
        if any(not x >= 0.0 for x in w):
            raise ValueError(f"score weights must be >= 0, got {w}")
        (self.w_load, self.w_backlog, self.w_pref, self.w_ux,
         self.w_xfer) = w

    def _bf(self, stream) -> float:
        """The stream's effective budget divisor: its SLO pipeline budget
        (head periods) when budget-aware routing is on, else the neutral
        1.0 (division by which is an IEEE no-op)."""
        if not self.budget_aware:
            return 1.0
        return getattr(stream, "budget_factor", 1.0)

    def score(self, stream, node: RoutableNode,
              best_iso: float) -> float:
        """Lower is better.  ``best_iso`` is the stream's best isolated
        latency across all candidate nodes (preference normalizer)."""
        return self._score(stream.cost_on(node), node, best_iso,
                           bf=self._bf(stream))

    def score_terms(self, cost: StreamCost, node: RoutableNode,
                    best_iso: float, tel=None,
                    bf: float = 1.0) -> tuple[float, float, float, float,
                                              float]:
        """The weight-independent factors of the node score, in full
        ``WEIGHT_NAMES`` order: the score is their dot product with the
        live weights, which is what lets the tuner re-score a recorded
        decision under counterfactual weight vectors without re-reading
        any node state.  The transfer column is 0 here — whole-stream
        placements never pay it; stage-level recording fills it with
        :meth:`transfer_term`.  ``tel`` lets a caller that already
        snapshotted the node's telemetry avoid a second walk of its live
        jobs."""
        if tel is None:
            tel = node.telemetry()
        load_after = tel.offered_util + cost.offered_s / tel.n_accs
        pref_penalty = (cost.iso_s / max(best_iso, 1e-12)) - 1.0
        urgency = min(cost.urgency / bf, URGENCY_CAP)
        return (load_after, tel.backlog_s / tel.n_accs,
                pref_penalty * urgency, min(tel.window_dlv, 1.0), 0.0)

    def _score(self, cost: StreamCost, node: RoutableNode,
               best_iso: float, bf: float = 1.0) -> float:
        t = self.score_terms(cost, node, best_iso, bf=bf)
        return (self.w_load * t[0] + self.w_backlog * t[1]
                + self.w_pref * t[2] + self.w_ux * t[3])

    # ------------------------------------------------------ batched scoring
    def batch_terms(self, b: _BatchInputs, best_iso: float) -> tuple:
        """The :meth:`score_terms` columns for every candidate at once:
        five (N,) arrays in ``WEIGHT_NAMES`` order plus the marginal
        offered load per node.  Each column replicates the scalar
        expression elementwise — same divisions, same ``min`` clamps
        (``np.minimum``), same subtraction order — so row ``i`` is
        bit-equal to ``score_terms(cost_on(nodes[i]), nodes[i], best_iso)``.
        """
        marginal = b.offered / b.n_accs
        t_load = b.offered_util + marginal
        t_backlog = b.backlog / b.n_accs
        pref_penalty = b.iso / max(best_iso, 1e-12) - 1.0
        bf = b.bf if self.budget_aware else 1.0
        t_pref = pref_penalty * np.minimum(b.urgency / bf, URGENCY_CAP)
        t_ux = np.minimum(b.dlv, 1.0)
        t_xfer = np.zeros(len(b.ids))
        return t_load, t_backlog, t_pref, t_ux, t_xfer, marginal

    def batch_scores(self, b: _BatchInputs, best_iso: float) -> np.ndarray:
        """Scores of one stream (or stage) on every candidate node as an
        (N,) array.  The weight chain is the same explicit elementwise
        expression as :meth:`_score` — deliberately NOT ``terms @ w``,
        whose dot-product reduction may reorder the additions."""
        t_load, t_backlog, t_pref, t_ux, _, _ = self.batch_terms(b, best_iso)
        return (self.w_load * t_load + self.w_backlog * t_backlog
                + self.w_pref * t_pref + self.w_ux * t_ux)

    def score_all(self, stream, nodes: Sequence[RoutableNode]) -> np.ndarray:
        """Batched :meth:`score` over ``nodes`` (including the best-iso
        normalizer pass): ``out[i] == self.score(stream, nodes[i],
        best_iso)`` bit-for-bit — the rebalancer's bulk entry point."""
        b = _BatchInputs(stream, nodes)
        return self.batch_scores(b, b.best_iso())

    def place(self, stream, nodes: Sequence[RoutableNode]) -> int:
        if not self.vectorized:
            return self._place_scalar(stream, nodes)
        b = _BatchInputs(stream, nodes)
        s = self.batch_scores(b, b.best_iso())
        # first-occurrence argmin == (score, node_id) tie-break: candidates
        # are sorted by node id
        return int(b.ids[int(np.argmin(s))])

    def _place_scalar(self, stream, nodes: Sequence[RoutableNode]) -> int:
        """Scalar reference placement — the oracle for the batched path."""
        best_iso = min(stream.cost_on(n).iso_s for n in nodes)
        return argmin_node(nodes,
                           lambda n: self.score(stream, n, best_iso))

    # ------------------------------------------------------ stage placement
    def transfer_penalty(self, stream, k: int, transfer) -> float:
        """Score penalty for putting stage ``k`` on a different node than
        its parent: the per-trigger transfer latency of the parent's output
        activation, relative to the stage's period (how much of every frame
        interval the wire eats), weighted by ``w_xfer``.  Infinite when the
        transfer model is absent or has zero bandwidth."""
        if transfer is None or not transfer.enabled:
            return float("inf")
        xfer_s = transfer.transfer_s(stream.act_bytes_into(k))
        return self.w_xfer * xfer_s / max(stream.stage_period_s(k), 1e-9)

    def transfer_term(self, stream, k: int, transfer) -> float:
        """The weight-independent factor of the transfer penalty (the
        ``xfer`` column of ``WEIGHT_NAMES``): per-trigger wire time over
        the receiving stage's period.  Infinite when the transfer model is
        absent or has zero bandwidth.  ``transfer_penalty`` is ``w_xfer``
        times this (up to float associativity — live scoring keeps its
        historical expression)."""
        if transfer is None or not transfer.enabled:
            return float("inf")
        xfer_s = transfer.transfer_s(stream.act_bytes_into(k))
        return xfer_s / max(stream.stage_period_s(k), 1e-9)

    def stage_score(self, stream, k: int, node: RoutableNode,
                    best_iso: float, parent_nid: Optional[int],
                    transfer) -> float:
        """Score of placing stage ``k`` on ``node`` given the stage's parent
        already landed on ``parent_nid`` (None for heads)."""
        s = self._score(stream.stage_cost_on(node, k), node, best_iso,
                        bf=self._bf(stream))
        if parent_nid is not None and node.node_id != parent_nid:
            s += self.transfer_penalty(stream, k, transfer)
        return s

    def place_stages(self, stream, nodes: Sequence[RoutableNode],
                     transfer) -> list[int]:
        """Split-refinement placement: anchor the head on the whole-stream
        ``place`` choice (which prices the full pipeline's load, so heads
        never land somewhere that cannot absorb the children that follow),
        then let each non-head stage peel off to another node only when its
        stage score there beats staying with its parent by more than the
        cascade-edge transfer penalty.  With zero bandwidth the penalty is
        infinite, every stage stays with its parent, and the assignment is
        exactly the whole-pipeline placement."""
        if not self.vectorized:
            return self._place_stages_scalar(stream, nodes, transfer)
        out: list[int] = [self.place(stream, nodes)]
        for k in range(1, stream.n_stages):
            b = _BatchInputs(stream, nodes, stage=k)
            s = self.batch_scores(b, b.best_iso())
            p = stream.parent_of(k)
            parent_nid = out[p] if p is not None else out[0]
            # the penalty is node-independent; adding it to the off-parent
            # rows (a plain elementwise add — inf-safe, nothing multiplies
            # the mask) replicates the scalar `s += transfer_penalty(...)`
            pen = self.transfer_penalty(stream, k, transfer)
            s = np.where(b.ids == parent_nid, s, s + pen)
            out.append(int(b.ids[int(np.argmin(s))]))
        return out

    def _place_stages_scalar(self, stream, nodes: Sequence[RoutableNode],
                             transfer) -> list[int]:
        """Scalar reference stage placement — the batched path's oracle."""
        out: list[int] = [self._place_scalar(stream, nodes)]
        for k in range(1, stream.n_stages):
            best_iso = min(stream.stage_cost_on(n, k).iso_s for n in nodes)
            p = stream.parent_of(k)
            parent_nid = out[p] if p is not None else out[0]
            out.append(argmin_node(
                nodes, lambda n: self.stage_score(stream, k, n, best_iso,
                                                  parent_nid, transfer)))
        return out


class WholePipelineScoreRouter(ScoreDrivenRouter):
    """Score-driven placement that never splits: every stage co-locates on
    the whole-stream choice — at admission, at migration, and at
    rebalance (``splits_stages = False`` makes the fleet move and
    rebalance streams as units).  This is the control arm for stage-split
    experiments — identical scoring, telemetry, migration accounting and
    trigger machinery, with placement granularity as the only variable."""

    name = "score_whole"
    splits_stages = False

    def place_stages(self, stream, nodes: Sequence[RoutableNode],
                     transfer) -> list[int]:
        return RouterPolicy.place_stages(self, stream, nodes, transfer)


#: multiplier-space bounds of the tuned router's probe: the same
#: constrained [0, 2] box the paper uses for (alpha, beta), applied per
#: weight as a *multiplier* on its static value — so "1.0 everywhere" is
#: exactly the hand-fixed ScoreDrivenRouter, and the tuner can at most
#: double or silence a term.  The load multiplier is floored at 0.25:
#: hindsight scoring rewards routing toward whatever nodes happened to be
#: healthy, and a zero capacity term would let the probe collapse onto
#: them — the floor keeps the static cost model load-bearing.
TUNE_LO = (0.25, 0.0, 0.0, 0.0, 0.0)
TUNE_HI = 2.0
#: coordinate-probe order: the static-estimate term first — under drift
#: the offline offered-load estimate is exactly the signal that goes
#: stale, so rebalancing its weight against the live terms (backlog,
#: health) is where the tuner finds most of its headroom — then hardware
#: preference, the live signals, and the transfer penalty last.
TUNE_AXIS_ORDER = (0, 2, 3, 1, 4)


class TunedScoreRouter(ScoreDrivenRouter):
    """Score-driven routing whose weights are *learned online* from fleet
    telemetry — the fleet-scale analogue of the per-node (alpha, beta)
    probe.

    The weight vector is parameterized as multipliers on
    ``STATIC_WEIGHTS`` searched over a constrained box by a
    :class:`repro_torch.core.adaptivity.CoordinateProbe`.  Candidates are
    scored in *hindsight* against each telemetry window's realized
    outcomes: the router records the weight-independent score terms of
    every placement decision it makes
    (:meth:`ScoreDrivenRouter.score_terms`), and at each window every
    candidate vector re-picks a node for every recorded decision, paying
    the realized deadline-violation rate (``TelemetryWindow.node_dlv`` —
    the DLV factor of the window's UXCost) of the node it would have
    chosen.  All candidates are judged on the
    *same* window, so cross-window drift cannot bias the comparison, and
    the fleet never deploys an untested candidate — the live router always
    runs the committed center.  The margin-gated best-wins commit
    (``CoordinateProbe.step_batch``) moves the center only on a clear win.

    Windows with zero frames, no recorded decisions, or no violations
    anywhere carry no ranking signal: the router holds its committed
    weights — a fresh tuner therefore behaves exactly like the static
    ``ScoreDrivenRouter`` until telemetry says otherwise.

    The JAX package's fleet simulator drives the loop (``tune_every_s``
    ticks); over serving engines ``repro_torch.launch.serve_fleet`` feeds
    one window per epoch.  The simulator re-arms the probe on membership
    churn and phase events
    (:meth:`rearm`), mirroring ``DreamScheduler.retrigger_probe``.  Tuner
    decisions are recorded in the fleet trace so replay bypasses the tuner
    entirely and stays bit-exact.
    """

    name = "tuned_score"
    #: cap on retained decision contexts between windows — far above any
    #: real window's placement count, it only guards the no-tune-ticks
    #: usage from unbounded growth
    MAX_DECISIONS = 4096
    #: optional duck-typed metrics registry (repro_torch.obs.MetricsRegistry),
    #: attached by the fleet when observability is on; publishing is
    #: observation only — nothing the tuner decides reads it back
    metrics = None

    def __init__(self, radius: float = 0.5, r_min: float = 0.08,
                 shrink: float = 0.7, margin: float = 0.3) -> None:
        super().__init__()
        n = len(STATIC_WEIGHTS)
        self.probe = CoordinateProbe(
            center=np.ones(n), lo=np.asarray(TUNE_LO),
            hi=np.full(n, TUNE_HI), radius=radius, r_min=r_min,
            shrink=shrink, margin=margin, axis_order=TUNE_AXIS_ORDER)
        self.windows_seen = 0
        self.empty_windows = 0
        self.held_windows = 0      # windows with no ranking signal
        #: decision contexts recorded since the last window: (node ids,
        #: terms matrix, marginal offered load per node) per placement
        #: decision, consumed and cleared every window.  Bounded: a tuned
        #: policy driven without tune ticks (tune_every_s unset — legal,
        #: it behaves exactly like the static router) must not accumulate
        #: contexts forever, so only the most recent window-scale batch
        #: is retained.
        self._decisions: "deque[tuple[list[int], np.ndarray, np.ndarray]]" \
            = deque(maxlen=self.MAX_DECISIONS)

    # ------------------------------------------------- decision recording
    def place(self, stream, nodes: Sequence[RoutableNode]) -> int:
        """Same argmin as the static router, computed from one batched
        pass of score terms — which then double as the recorded decision
        context, so recording costs no extra node scans."""
        if not self.vectorized:
            return self._place_scalar(stream, nodes)
        b = _BatchInputs(stream, nodes)
        (t_load, t_backlog, t_pref, t_ux, t_xfer,
         marginal) = self.batch_terms(b, b.best_iso())
        # same expression order as batch_scores / _score, so the argmin is
        # bit-identical to ScoreDrivenRouter.place
        s = (self.w_load * t_load + self.w_backlog * t_backlog
             + self.w_pref * t_pref + self.w_ux * t_ux)
        self._decisions.append(
            ([int(i) for i in b.ids],
             np.column_stack((t_load, t_backlog, t_pref, t_ux, t_xfer)),
             marginal))
        return int(b.ids[int(np.argmin(s))])

    def _place_scalar(self, stream, nodes: Sequence[RoutableNode]) -> int:
        """Scalar reference of the recording placement (test oracle)."""
        best_iso = min(stream.cost_on(n).iso_s for n in nodes)
        bf = self._bf(stream)
        ids: list[int] = []
        rows: list[tuple[float, ...]] = []
        marginal: list[float] = []
        best_nid, best_key = nodes[0].node_id, None
        for n in nodes:
            cost = stream.cost_on(n)
            tel = n.telemetry()
            t = self.score_terms(cost, n, best_iso, tel=tel, bf=bf)
            s = (self.w_load * t[0] + self.w_backlog * t[1]
                 + self.w_pref * t[2] + self.w_ux * t[3])
            key = (s, n.node_id)
            if best_key is None or key < best_key:
                best_nid, best_key = n.node_id, key
            ids.append(n.node_id)
            rows.append(t)
            marginal.append(cost.offered_s / tel.n_accs)
        self._decisions.append((ids, np.asarray(rows),
                                np.asarray(marginal)))
        return best_nid

    #: recorded transfer terms are clamped to this finite cap: a missing /
    #: zero-bandwidth link scores +inf live (the stage stays with its
    #: parent), but an inf left in a recorded context would turn into nan
    #: under a candidate that zeroes the transfer multiplier in hindsight
    XFER_TERM_CAP = 1e9

    def place_stages(self, stream, nodes: Sequence[RoutableNode],
                     transfer) -> list[int]:
        """Same split-refinement argmin as the static router, but every
        *stage* decision is recorded too — with the transfer column of the
        terms filled in (:meth:`ScoreDrivenRouter.transfer_term` for
        off-parent nodes, 0 for staying with the parent) — so hindsight
        re-scoring learns ``W_XFER`` from realized outcomes as well, not
        only the whole-stream columns."""
        if not self.vectorized:
            return self._place_stages_scalar(stream, nodes, transfer)
        out: list[int] = [self.place(stream, nodes)]
        for k in range(1, stream.n_stages):
            b = _BatchInputs(stream, nodes, stage=k)
            (t_load, t_backlog, t_pref, t_ux, _,
             marginal) = self.batch_terms(b, b.best_iso())
            s = (self.w_load * t_load + self.w_backlog * t_backlog
                 + self.w_pref * t_pref + self.w_ux * t_ux)
            p = stream.parent_of(k)
            parent_nid = out[p] if p is not None else out[0]
            on_parent = b.ids == parent_nid
            # node-independent penalty/term, added (never multiplied) to
            # the off-parent rows so an infinite penalty stays inf-safe
            pen = self.transfer_penalty(stream, k, transfer)
            s = np.where(on_parent, s, s + pen)
            xfer = min(self.transfer_term(stream, k, transfer),
                       self.XFER_TERM_CAP)
            t_xfer = np.where(on_parent, 0.0, xfer)
            self._decisions.append(
                ([int(i) for i in b.ids],
                 np.column_stack((t_load, t_backlog, t_pref, t_ux, t_xfer)),
                 marginal))
            out.append(int(b.ids[int(np.argmin(s))]))
        return out

    def _place_stages_scalar(self, stream, nodes: Sequence[RoutableNode],
                             transfer) -> list[int]:
        """Scalar reference of the recording stage placement (oracle)."""
        out: list[int] = [self._place_scalar(stream, nodes)]
        bf = self._bf(stream)
        for k in range(1, stream.n_stages):
            best_iso = min(stream.stage_cost_on(n, k).iso_s for n in nodes)
            p = stream.parent_of(k)
            parent_nid = out[p] if p is not None else out[0]
            ids: list[int] = []
            rows: list[tuple[float, ...]] = []
            marginal: list[float] = []
            best_nid, best_key = nodes[0].node_id, None
            for n in nodes:
                cost = stream.stage_cost_on(n, k)
                tel = n.telemetry()
                t = self.score_terms(cost, n, best_iso, tel=tel, bf=bf)
                # identical arithmetic to stage_score: 4-term dot product
                # plus the historical transfer_penalty expression
                s = (self.w_load * t[0] + self.w_backlog * t[1]
                     + self.w_pref * t[2] + self.w_ux * t[3])
                xfer = 0.0
                if n.node_id != parent_nid:
                    s += self.transfer_penalty(stream, k, transfer)
                    xfer = min(self.transfer_term(stream, k, transfer),
                               self.XFER_TERM_CAP)
                key = (s, n.node_id)
                if best_key is None or key < best_key:
                    best_nid, best_key = n.node_id, key
                ids.append(n.node_id)
                rows.append(t[:4] + (xfer,))
                marginal.append(cost.offered_s / tel.n_accs)
            self._decisions.append((ids, np.asarray(rows),
                                    np.asarray(marginal)))
            out.append(best_nid)
        return out

    # --------------------------------------------------------- tuner loop
    @property
    def multipliers(self) -> np.ndarray:
        """The live multiplier vector (weights / STATIC_WEIGHTS)."""
        return np.asarray(self.weights) / np.asarray(STATIC_WEIGHTS)

    def _apply(self, mult: np.ndarray) -> None:
        self.set_weights([m * w for m, w in zip(mult, STATIC_WEIGHTS)])

    #: predicted-overload knee of the hindsight cost: counterfactual
    #: placements that push a node's accumulated offered utilization past
    #: this are charged the excess, so a candidate cannot look good by
    #: piling every decision onto whichever node happened to be healthy
    OVERLOAD_KNEE = 1.0

    def _hindsight_cost(self, decisions, node_dlv) -> "Callable":
        """Cost function for the probe: replay the window's recorded
        placement decisions under a candidate weight vector and charge,
        per decision, the realized DLV rate of the node the candidate
        would have picked — plus the predicted overload its *own*
        counterfactual placements would cause.

        The replay is sequential and capacity-aware: each counterfactual
        placement adds the stream's marginal offered load to the chosen
        node's load term for the window's later decisions (the same
        feedback a deployed router would have had), which is what stops
        hindsight-greedy candidates from concentrating on the one node
        that happened to realize zero violations.  Terms matrices are
        5-wide (full ``WEIGHT_NAMES`` order): whole-stream decisions carry
        a zero transfer column, stage-split decisions the real one — so
        ``W_XFER`` is learned from hindsight too."""
        def cost_fn(mult: np.ndarray) -> float:
            w = np.asarray(mult) * np.asarray(STATIC_WEIGHTS)
            extra: dict[int, float] = {}
            total = 0.0
            for ids, terms, marginal in decisions:
                scores = terms @ w
                if extra:
                    scores = scores + w[0] * np.asarray(
                        [extra.get(i, 0.0) for i in ids])
                # ids are ascending, so argmin ties break to lower node id
                k = int(np.argmin(scores))
                nid = ids[k]
                # terms[k,0] is the post-placement estimate (it already
                # includes this decision's own marginal) — add only the
                # load accumulated by *earlier* counterfactual placements
                load_after = float(terms[k, 0]) + extra.get(nid, 0.0)
                extra[nid] = extra.get(nid, 0.0) + float(marginal[k])
                total += (node_dlv.get(nid, 0.0)
                          + max(0.0, load_after - self.OVERLOAD_KNEE))
            return total / len(decisions)
        return cost_fn

    def on_window(self, window, rng) -> "Optional[tuple[float, ...]]":
        """Feed one telemetry window; returns the weight vector now live
        (``None`` when the window carried no signal and weights held)."""
        self.windows_seen += 1
        decisions = list(self._decisions)
        self._decisions.clear()
        if window.empty:
            # zero-length / frame-free window: no feedback signal — fall
            # back to the committed weights rather than score a vacuous 0
            self.empty_windows += 1
            return None
        if not decisions or not any(v > 0.0
                                    for v in window.node_dlv.values()):
            # nothing to re-score, or a violation-free fleet: every
            # candidate would tie at zero — hold the committed weights
            self.held_windows += 1
            return None
        self._apply(self.probe.step_batch(
            self._hindsight_cost(decisions, window.node_dlv), rng))
        if self.metrics is not None:
            g = self.metrics.gauge(
                "router_weight", "live router score weights", ("name",))
            for name, w in zip(WEIGHT_NAMES, self.weights):
                g.set(w, name=name)
            self.metrics.counter(
                "router_tune_commits_total",
                "tuner windows that re-scored weights").inc()
        return self.weights

    def rearm(self) -> None:
        """Membership churn / phase event: the workload changed, so the
        committed weights may be stale — widen and restart the probe."""
        self.probe.retrigger()


POLICIES = {
    "round_robin": RoundRobinRouter,
    "least_loaded": LeastLoadedRouter,
    "score": ScoreDrivenRouter,
    "score_whole": WholePipelineScoreRouter,
    "tuned_score": TunedScoreRouter,
}


def make_policy(policy: "str | RouterPolicy") -> RouterPolicy:
    if isinstance(policy, RouterPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown router policy {policy!r}; "
                         f"choose from {sorted(POLICIES)}") from None
