"""Kinematics models for cost functions (JAX counterpart: theseus_tpu/embodied/kinematics.py).

`IdentityModel` passes a pose through; `UrdfRobotModel` maps joint angles
to link poses by the differentiable forward kinematics of `kin/`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..kin import Robot, get_forward_kinematics_fns


class KinematicsModel:
    def forward_kinematics(self, robot_pose) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class IdentityModel(KinematicsModel):
    """forward_kinematics(pose) = {"state": pose}."""

    def forward_kinematics(self, robot_pose) -> Dict[str, torch.Tensor]:
        return {"state": robot_pose}


class UrdfRobotModel(KinematicsModel):
    """Forward kinematics from a URDF file or string. `link_names` selects
    the outputs (default: every joint's child link); forward_kinematics
    takes joint angles (..., dof)."""

    def __init__(self, urdf_path: Optional[str] = None, urdf_string: Optional[str] = None,
                 link_names: Optional[Sequence[str]] = None):
        if (urdf_path is None) == (urdf_string is None):
            raise ValueError("Provide exactly one of urdf_path / urdf_string.")
        self.robot = Robot.from_urdf_file(urdf_path) if urdf_path else Robot.from_urdf_string(urdf_string)
        self.link_names = list(link_names if link_names is not None else [j.child_link for j in self.robot.joints])
        self._fk, self._jfk_b, self._jfk_s = get_forward_kinematics_fns(self.robot, self.link_names)

    @property
    def dof(self) -> int:
        return self.robot.dof

    def forward_kinematics(self, joint_angles) -> Dict[str, torch.Tensor]:
        return dict(zip(self.link_names, self._fk(joint_angles)))

    def fk_with_body_jacobians(self, joint_angles):
        jacs, poses = self._jfk_b(joint_angles)
        return dict(zip(self.link_names, poses)), dict(zip(self.link_names, jacs))
