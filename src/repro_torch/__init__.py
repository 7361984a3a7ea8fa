"""repro_torch: the serving stack of ``repro`` on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

Layout mirrors the JAX package module for module (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``). Nothing here imports JAX or
the JAX package.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA on a machine without it raises; nothing falls
    back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

