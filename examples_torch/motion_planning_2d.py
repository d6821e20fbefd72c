"""GPMP2-style 2D motion planning around an obstacle (the port of examples/motion_planning_2d.py).

GP motion priors plus SDF collision hinge costs, solved by LM. Runs on the
card unless --device cpu is given.

    python examples_torch/motion_planning_2d.py [--map-size 32] [--num-time-steps 24] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.embodied import occupancy_to_sdf
from theseus_tpu_torch.utils.examples.motion_planning import MotionPlanner


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--map-size", type=int, default=32)
    p.add_argument("--cell-size", type=float, default=0.1)
    p.add_argument("--num-time-steps", type=int, default=24)
    p.add_argument("--total-time", type=float, default=2.0)
    p.add_argument("--epsilon-dist", type=float, default=0.25)
    p.add_argument("--collision-weight", type=float, default=40.0)
    p.add_argument("--max-iterations", type=int, default=60)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    dev = config.resolve_device(args.device)

    map_size, cell = args.map_size, args.cell_size
    occ = np.zeros((map_size, map_size))
    h = map_size
    occ[h * 10 // 32: h * 22 // 32, h * 14 // 32: h * 18 // 32] = 1.0
    occ[h * 16 // 32: h * 18 // 32, h * 14 // 32: h * 18 // 32] = 0.0
    sdf = occupancy_to_sdf(occ, cell)

    planner = MotionPlanner(map_size=map_size, epsilon_dist=args.epsilon_dist, total_time=args.total_time,
                            collision_weight=args.collision_weight, Qc_inv=np.eye(2),
                            num_time_steps=args.num_time_steps, max_iterations=args.max_iterations,
                            device=dev, adaptive_damping=True)
    # start and goal from the map extent, so that other --map-size or
    # --cell-size values keep both inside the SDF
    extent = map_size * cell
    f64 = dict(dtype=torch.float64, device=dev)
    values, info = planner.solve(torch.tensor([[0.09375 * extent, 0.5 * extent]], **f64),
                                 torch.tensor([[0.90625 * extent, 0.5 * extent]], **f64),
                                 sdf_origin=torch.zeros((1, 2), **f64),
                                 sdf_data=torch.as_tensor(sdf, **f64)[None],
                                 cell_size=torch.tensor([[cell]], **f64))
    traj = planner.trajectory(values)[0].cpu().numpy()
    print("status:", info.status.cpu().numpy(), "final err:", float(info.last_err[0]))
    print("trajectory (every 4th):")
    for q in traj[::4]:
        print(f"  ({q[0]:.2f}, {q[1]:.2f})")


if __name__ == "__main__":
    main()
