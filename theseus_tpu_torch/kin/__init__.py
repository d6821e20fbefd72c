"""Kinematics: URDF parsing, the robot model and forward kinematics (JAX counterpart: theseus_tpu/kin/__init__.py)."""

from .fk import get_forward_kinematics_fns, joint_child_poses
from .robot import JointSpec, Robot
from .urdf import origin_pose, parse_urdf, rpy_to_matrix

__all__ = ["get_forward_kinematics_fns", "joint_child_poses", "JointSpec", "Robot",
           "origin_pose", "parse_urdf", "rpy_to_matrix"]
