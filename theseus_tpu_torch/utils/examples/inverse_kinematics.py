"""The 7-dof arm inverse-kinematics problem that the serving path solves (JAX counterpart: evaluations/serving_throughput.py).

One `AutoDiffCostFunction` over forward kinematics: the SE3 local of the
end effector's pose to its target, over the seven joint angles (a Vector),
solved by Levenberg-Marquardt with adaptive damping on the default dense
linearization, `IK_ITERS` iterations from zero. Targets are the end
effector's poses at `0.7 * randn` joint angles from a seeded
torch.Generator.

The cost's jacobians are taken in reverse mode by default
(`autograd_mode="rev"`, torch.func.jacrev): the residual (6) is narrower
than the variable (7), the JAX package's own rule for "rev", and in
eager PyTorch the forward-mode linearization costs 1.5x the host time
(chip_smoke.py's IK stage times; PERF.md §5). The JAX serving harness
uses "fwd"; both give the same jacobian to rounding.

    layer, fk, robot = build_ik_layer(torch.float32, "cuda")
    targets = ik_targets(fk, robot.dof, batch, torch.float32, "cuda")
    out, info = layer.forward({"theta": torch.zeros(batch, robot.dof, ...),
                               "target": targets})
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...core import AutoDiffCostFunction, Objective
from ...core.variable import Variable, Vector
from ...kin import Robot, get_forward_kinematics_fns
from ...layer import TheseusLayer
from ...lie import SE3
from ...optim import LevenbergMarquardt

ARM_7DOF = """
<robot name="arm7">
  <link name="base"/> <link name="l1"/> <link name="l2"/> <link name="l3"/>
  <link name="l4"/> <link name="l5"/> <link name="l6"/> <link name="ee"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.3"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="l2"/><child link="l3"/>
    <origin xyz="0 0 0.25"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="j4" type="revolute">
    <parent link="l3"/><child link="l4"/>
    <origin xyz="0 0 0.25"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="j5" type="revolute">
    <parent link="l4"/><child link="l5"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="j6" type="revolute">
    <parent link="l5"/><child link="l6"/>
    <origin xyz="0 0 0.15"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="j7" type="revolute">
    <parent link="l6"/><child link="ee"/>
    <origin xyz="0 0 0.1"/><axis xyz="1 0 0"/>
  </joint>
</robot>
"""

IK_ITERS = 12
TARGET_SCALE = 0.7


def build_ik_layer(dtype: torch.dtype = torch.float32, device=None, iters: int = IK_ITERS,
                   urdf: str = ARM_7DOF, link: str = "ee", autograd_mode: str = "rev", **opt_kwargs):
    """(TheseusLayer, fk, robot) for the IK of `link`. Inputs: "theta"
    (B, dof) initial joint angles, "target" (B, 3, 4) poses."""
    robot = Robot.from_urdf_string(urdf)
    fk, _, _ = get_forward_kinematics_fns(robot, [link])

    def ik_err(optim, aux):
        (th,) = optim
        (tgt,) = aux
        (pose,) = fk(th)
        return SE3.local(tgt, pose)

    target = Variable(np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)[None], name="target")
    obj = Objective(dtype=dtype, device=resolve_device(device))
    obj.add(AutoDiffCostFunction([Vector(robot.dof, name="theta")], 6, ik_err, aux_vars=[target], name="ik",
                                 autograd_mode=autograd_mode))
    opt_kwargs.setdefault("adaptive_damping", True)
    return TheseusLayer(LevenbergMarquardt(obj, max_iterations=iters, **opt_kwargs)), fk, robot


def ik_targets(fk, dof: int, batch: int, dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
    """(B, 3, 4) end-effector poses at 0.7 * randn joint angles, drawn from
    a torch.Generator seeded by `seed` on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    theta = TARGET_SCALE * torch.randn(batch, dof, generator=gen, dtype=torch.float64)
    (pose,) = fk(theta.to(dtype=dtype, device=resolve_device(device)))
    return pose


def perturb_targets(targets: torch.Tensor, i: int, scale: float = 1e-7) -> torch.Tensor:
    """Request i's targets: every translation moved by scale * (i + 1), so
    that each call brings new inputs."""
    shift = torch.zeros_like(targets)
    shift[..., 3] = scale * (i + 1)
    return targets + shift
