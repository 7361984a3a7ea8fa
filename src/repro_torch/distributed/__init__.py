"""Distributed substrate: checkpointing, gradient compression, straggler
detection and fault injection. Sharding rules and the device mesh wait for
ROADMAP queue A item 4."""
from .checkpoint import CheckpointManager  # noqa: F401
from .compression import (CompressionConfig, compress_with_feedback,  # noqa
                          compressed_bytes, init_error_state)
from .elastic import (FaultInjector, SimulatedPreemption,  # noqa: F401
                      StragglerDetector, best_mesh_shape)
