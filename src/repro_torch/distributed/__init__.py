"""Distributed substrate: logical-axis sharding onto a device mesh,
checkpointing (restore onto a mesh is the reshard), gradient compression,
the elastic re-mesh, straggler detection and fault injection."""
from .checkpoint import CheckpointManager  # noqa: F401
from .compression import (CompressionConfig, compress_with_feedback,  # noqa
                          compressed_bytes, init_error_state)
from .elastic import (FaultInjector, SimulatedPreemption,  # noqa: F401
                      StragglerDetector, best_mesh_shape, remesh)
