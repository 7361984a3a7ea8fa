"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Layout (per kernel): ``csrc/<name>.cu`` holds the CUDA C++ source with a
plain C entry point, ``<name>.py`` its ctypes binding, argument checks and
launch counter, ``ref.py`` the plain version, and ``ops.py`` the public
wrapper that pads and picks the kernel (CUDA tensors) or the plain version
(CPU tensors). ``build.py`` compiles the sources with nvcc at first use.

Import the wrappers via ``from repro_torch.kernels import ops``.
"""
from . import ops, ref  # noqa: F401
