"""Fleet subsystem: multi-node DREAM behind a score-driven global router
(copy of ``repro/cluster``).

Composes N per-node simulators (heterogeneous Table-2 systems per node)
under a fleet clock with pluggable routing policies, elastic membership
(node join / drain / leave with stream migration and adaptivity-probe
re-triggering), fleet-level UXCost aggregation, SLO admission and
degradation, and a JSONL fleet trace whose replay reproduces an entire run
bit-exactly (and whose bytes equal the reference's, so traces cross the two
packages). The router and its telemetry windows also route live serving
engines (``repro_torch.launch.serve_fleet``), through the narrow
:class:`~.node.RoutableNode` surface.

``fleet.py`` documents the copy's one deviation from the reference: its
scan fleet clock refreshes the nodes a stage-split interleave stepped.
"""
from ..core.costmodel import ContendedLinks, TransferModel

from .builder import (CascadeFuzz, FleetEvent, FleetScenario,
                      FleetScenarioBuilder, FuzzSpec, GenAIFuzz,
                      LifecycleFuzz, SLOFuzz, split_pipelines)
from .fleet import (FleetResult, FleetSimulator, StreamView,
                    canonical_stream_model, node_seed, run_fleet)
from .node import FleetNode, NodeTelemetry, RoutableNode, StreamCost
from .router import (POLICIES, STATIC_WEIGHTS, TUNE_AXIS_ORDER, TUNE_HI,
                     TUNE_LO, WEIGHT_NAMES, LeastLoadedRouter,
                     RoundRobinRouter, RouterPolicy, ScoreDrivenRouter,
                     TunedScoreRouter, WholePipelineScoreRouter, make_policy)
from .slo import (DEFAULT_SLO, TIER_BEST_EFFORT, TIER_DEFAULTS,
                  TIER_GUARANTEED, TIER_STANDARD, AdmissionController,
                  LoadEstimator, SLOClass, SLOError, StreamState,
                  slo_from_config)
from .telemetry import FleetTelemetry, TelemetryWindow
from .trace import (FLEET_EVENT_KINDS, FLEET_TRACE_VERSION, FleetTrace,
                    FleetTraceRecorder, dumps, load_trace, loads, save_trace)

__all__ = [
    "ContendedLinks", "TransferModel",
    "CascadeFuzz", "FleetEvent", "FleetScenario", "FleetScenarioBuilder",
    "FuzzSpec", "GenAIFuzz", "LifecycleFuzz", "SLOFuzz", "split_pipelines",
    "FleetResult", "FleetSimulator", "StreamView", "canonical_stream_model",
    "node_seed", "run_fleet",
    "FleetNode", "NodeTelemetry", "StreamCost",
    "POLICIES", "STATIC_WEIGHTS", "WEIGHT_NAMES", "LeastLoadedRouter",
    "RoundRobinRouter", "RouterPolicy", "ScoreDrivenRouter",
    "TunedScoreRouter", "make_policy",
    "DEFAULT_SLO", "TIER_BEST_EFFORT", "TIER_DEFAULTS", "TIER_GUARANTEED",
    "TIER_STANDARD", "AdmissionController", "LoadEstimator", "SLOClass",
    "SLOError", "StreamState", "slo_from_config",
    "FleetTelemetry", "TelemetryWindow",
    "FLEET_EVENT_KINDS", "FLEET_TRACE_VERSION", "FleetTrace",
    "FleetTraceRecorder", "dumps", "load_trace", "loads", "save_trace",
]
