"""PGO cost functions (JAX counterpart: theseus_tpu/embodied/__init__.py)."""

from .measurements import Between
from .misc import Difference, Local

__all__ = ["Between", "Difference", "Local"]
