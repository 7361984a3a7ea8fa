"""Multi-model real-time serving: the DREAM scheduler driving PyTorch models."""
from .engine import (EngineReport, ModelHandle, RequestQueue,  # noqa: F401
                     ServeRequest, ServingEngine, VirtualAccelerator)
