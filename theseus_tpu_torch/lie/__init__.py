"""Functional Lie-group layer (JAX counterpart: theseus_tpu/lie/__init__.py)."""

from . import rn, se3, so3, utils
from .group import SE3, Group, by_name, euclidean

__all__ = ["rn", "se3", "so3", "utils", "Group", "SE3", "by_name", "euclidean"]
