"""SE2 trajectory optimization with nonholonomic constraints (the port of examples/se2_planning.py).

Plan SE2 poses and velocities from start to goal with a double-integrator
prior, penalizing sideways velocity. Runs on the card unless --device cpu
is given.

    python examples_torch/se2_planning.py [--num-steps 16] [--dt 0.25] [--device cpu]
"""

import argparse
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

import theseus_tpu_torch as tt
from examples_torch import _config
from theseus_tpu_torch import config


def plan(num_steps=16, dt=0.25, max_iterations=80, nonholonomic_weight=50.0, device=None):
    """(values, info) of the float64 LM plan."""
    n = num_steps
    dtype = torch.float64
    obj = tt.Objective(dtype=dtype, device=device)
    dev = obj.device
    poses = [tt.SE2(name=f"pose_{i}") for i in range(n)]
    vels = [tt.Vector(3, name=f"vel_{i}") for i in range(n)]

    start = torch.tensor([[0.0, 0.0, 1.0, 0.0]], dtype=dtype)  # (x, y, cos, sin)
    goal = torch.tensor([[2.0, 1.0, 0.0, 1.0]], dtype=dtype)
    zero = torch.zeros((1, 3), dtype=dtype)
    bw = tt.ScaleCostWeight(torch.tensor(100.0, dtype=dtype))
    obj.add(tt.Local(poses[0], start, bw, name="start"))
    obj.add(tt.Local(poses[-1], goal, bw, name="goal"))
    obj.add(tt.Local(vels[0], zero, bw, name="v0"))
    obj.add(tt.Local(vels[-1], zero, bw, name="vT"))
    dw = tt.ScaleCostWeight(torch.tensor(5.0, dtype=dtype))
    nw = tt.ScaleCostWeight(torch.tensor(float(nonholonomic_weight), dtype=dtype))
    for i in range(n - 1):
        obj.add(tt.DoubleIntegrator(poses[i], vels[i], poses[i + 1], vels[i + 1], dt, dw, name=f"di_{i}"))
    for i in range(n):
        obj.add(tt.Nonholonomic(poses[i], vels[i], nw, name=f"nh_{i}"))

    init = {f"pose_{i}": start.to(dev) for i in range(n)}
    init.update({f"vel_{i}": zero.to(dev) for i in range(n)})
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=max_iterations, adaptive_damping=True))
    return layer.forward(init)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-steps", type=int, default=16)
    p.add_argument("--dt", type=float, default=0.25)
    p.add_argument("--max-iterations", type=int, default=80)
    p.add_argument("--nonholonomic-weight", type=float, default=50.0)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    n = args.num_steps
    values, info = plan(n, args.dt, args.max_iterations, args.nonholonomic_weight,
                        config.resolve_device(args.device))
    print("status:", info.status.cpu().numpy(), "final err:", float(info.last_err[0]))
    print("trajectory (x, y, heading):")
    for i in range(0, n, 3):
        q = values[f"pose_{i}"][0].tolist()
        print(f"  ({q[0]:+.2f}, {q[1]:+.2f}, {math.atan2(q[3], q[2]):+.2f})")
    side_vel = max(abs(float(values[f"vel_{i}"][0, 1])) for i in range(n))
    print("max sideways velocity:", side_vel)


if __name__ == "__main__":
    main()
