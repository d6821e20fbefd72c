"""Inverse kinematics by NLLS over joint angles (the port of examples/inverse_kinematics.py).

The residual is the local() difference between the forward-kinematics
end-effector pose of a 5-dof arm and a target pose reached by known joint
angles. Runs on the card unless --device cpu is given.

    python examples_torch/inverse_kinematics.py [--max-iterations 50] [--target-joints a b c d e] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

import theseus_tpu_torch as tt
from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.kin import Robot, get_forward_kinematics_fns
from theseus_tpu_torch.lie import SE3

ARM_5DOF = """
<robot name="arm5">
  <link name="base"/> <link name="l1"/> <link name="l2"/>
  <link name="l3"/> <link name="l4"/> <link name="ee"/>
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
    <origin xyz="0 0 0.3"/><axis xyz="0 1 0"/>
  </joint>
  <joint name="j4" type="revolute">
    <parent link="l3"/><child link="l4"/>
    <origin xyz="0 0 0.3"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="j5" type="revolute">
    <parent link="l4"/><child link="ee"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 1 0"/>
  </joint>
</robot>
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--target-joints", type=float, nargs=5, default=[0.4, -0.6, 0.8, 0.3, -0.5])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    dev = config.resolve_device(args.device)

    robot = Robot.from_urdf_string(ARM_5DOF)
    fk, _, _ = get_forward_kinematics_fns(robot, ["ee"])
    (target_pose,) = fk(torch.tensor(args.target_joints, device=dev))

    theta_var = tt.Vector(robot.dof, name="theta")
    target = tt.Variable(target_pose[None], name="target")

    def ik_err(optim, aux):
        (th,) = optim
        (tgt,) = aux
        (pose,) = fk(th)
        return SE3.local(tgt, pose)

    obj = tt.Objective(device=dev)
    obj.add(tt.AutoDiffCostFunction([theta_var], 6, ik_err, aux_vars=[target], name="ik"))
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=args.max_iterations, adaptive_damping=True))
    values, info = layer.forward({"theta": torch.zeros((1, robot.dof), device=dev)})
    (sol_pose,) = fk(values["theta"][0])
    err = SE3.local(target_pose, sol_pose).abs()
    print("solved joints:", values["theta"][0].cpu().numpy())
    print("pose error:", err.cpu().numpy(), "status:", info.status.cpu().numpy())
    assert float(err.max()) < 1e-4


if __name__ == "__main__":
    main()
