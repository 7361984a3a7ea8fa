"""DREAM core: the paper's scheduler, metrics, workloads and simulator (copies
of the JAX package's numpy modules; the same inputs give the same results
bit for bit)."""
from .types import (Accelerator, Dataflow, Layer, ModelGraph, ModelSpec, OpType,
                    Scenario, SYSTEMS, HETERO_SYSTEMS, HOMO_SYSTEMS)
from .costmodel import (ContendedLinks, CostTable, TransferModel,
                        activation_bytes, build_cost_table, build_tables,
                        layer_energy_j, layer_latency_s, model_state_bytes)
from .engine import ENGINE_PRESETS, EngineConfig
from .mapscore import MapScoreParams, mapscore, togo_seconds, min_togo_seconds
from .uxcost import (WindowStats, uxcost, rate_dlv, norm_energy,
                     overall_pipeline_latency)
from .simulator import Dispatch, Job, SchedulerBase, SimResult, Simulator, run_sim
from .scheduler import (DreamScheduler, dream_mapscore, dream_smartdrop,
                        dream_full, AdaptivityState)
from .baselines import (FCFSScheduler, StaticFCFSScheduler, VeltairLikeScheduler,
                        PlanariaSimulator, run_planaria)
from .adaptivity import optimize_params, grid_search, SearchTrace
from .workloads import SCENARIOS, build_scenario

__all__ = [
    "Accelerator", "Dataflow", "Layer", "ModelGraph", "ModelSpec", "OpType",
    "Scenario", "SYSTEMS", "HETERO_SYSTEMS", "HOMO_SYSTEMS",
    "ContendedLinks", "CostTable", "TransferModel", "activation_bytes",
    "build_cost_table",
    "build_tables", "layer_energy_j", "layer_latency_s", "model_state_bytes",
    "ENGINE_PRESETS", "EngineConfig",
    "MapScoreParams", "mapscore", "togo_seconds",
    "min_togo_seconds", "WindowStats", "uxcost", "rate_dlv", "norm_energy",
    "overall_pipeline_latency",
    "Dispatch", "Job", "SchedulerBase", "SimResult", "Simulator", "run_sim",
    "DreamScheduler", "dream_mapscore", "dream_smartdrop", "dream_full",
    "AdaptivityState", "FCFSScheduler", "StaticFCFSScheduler",
    "VeltairLikeScheduler", "PlanariaSimulator", "run_planaria",
    "optimize_params", "grid_search", "SearchTrace", "SCENARIOS",
    "build_scenario",
]
