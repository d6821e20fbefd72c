"""Functional Lie-group layer (JAX counterpart: theseus_tpu/lie/__init__.py)."""

from . import se3, so3, utils
from .group import SE3, Group, by_name

__all__ = ["se3", "so3", "utils", "Group", "SE3", "by_name"]
