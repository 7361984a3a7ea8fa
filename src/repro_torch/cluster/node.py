"""What the global router reads of a fleet node (the part of
``repro/cluster/node.py`` that the router and the serving fleet need).

:class:`NodeTelemetry` and :class:`StreamCost` are copies of the
reference's. The reference's ``FleetNode`` wraps its discrete-event
simulator and is not ported yet; the router types its nodes against
:class:`RoutableNode`, the narrow surface it reads: a ``node_id`` and a
``telemetry()`` snapshot. A stream's cost on a node comes from the stream
(``stream.cost_on(node)``), so any object with these two members can be
routed: a simulated fleet node or a live serving engine
(``repro_torch.launch.serve_fleet.EngineNode``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol


@dataclass(frozen=True)
class NodeTelemetry:
    """Router-visible snapshot of one node (all fields cheap to compute)."""

    node_id: int
    system: str
    n_accs: int
    queue_depth: int        # jobs ready or running right now
    active_streams: int     # streams currently placed here
    backlog_s: float        # summed mean to-go latency of live jobs (s)
    offered_util: float     # placed streams' offered load / accelerator count
    window_uxcost: float    # most recent UXCost window (0 before the first)
    window_dlv: float       # DLV rate over the most recent advance span
    utilization: float      # cumulative busy fraction so far
    drops: int
    draining: bool


@dataclass(frozen=True)
class StreamCost:
    """MapScore-style summary of one stream on one node's accelerator mix."""

    iso_s: float            # best-accelerator isolated latency, full pipeline
    offered_s: float        # expected busy-seconds per wall-clock second
    urgency: float          # iso latency / head period (deadline tightness)


class RoutableNode(Protocol):
    """The node surface every router policy reads. A node may also carry a
    ``system`` name: nodes of one named system share a stream's cost in
    the batched scoring path, and a node without one is costed alone."""

    node_id: int

    def telemetry(self) -> NodeTelemetry: ...
