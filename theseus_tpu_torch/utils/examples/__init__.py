"""Example problems (JAX counterpart: theseus_tpu/utils/examples/__init__.py)."""

from . import easyaug, homography, pose_graph
