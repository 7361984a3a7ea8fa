"""Data pipeline substrate."""
from .pipeline import SyntheticLMData, mask_prefix  # noqa: F401
