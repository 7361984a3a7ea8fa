"""PyTorch model substrate for the serving slice's architectures.

Functional (init/apply pairs over plain dicts of tensors) with the JAX
package's parameter names and layouts.
"""
from .model import LM, forward, init_params  # noqa: F401
