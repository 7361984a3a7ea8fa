"""Fleet layer: the global router, its telemetry windows and the node
surface it reads (the part of ``repro.cluster`` that routes serving
engines; the fleet simulator, SLO admission and fleet traces are not
ported yet)."""
from .node import NodeTelemetry, RoutableNode, StreamCost  # noqa: F401
from .router import (POLICIES, STATIC_WEIGHTS, TUNE_AXIS_ORDER,  # noqa: F401
                     TUNE_HI, TUNE_LO, WEIGHT_NAMES, LeastLoadedRouter,
                     RoundRobinRouter, RouterPolicy, ScoreDrivenRouter,
                     TunedScoreRouter, WholePipelineScoreRouter, make_policy)
from .telemetry import FleetTelemetry, TelemetryWindow  # noqa: F401
