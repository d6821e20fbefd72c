# %% [markdown]
# # Tutorial 4: Motion planning
#
# (the PyTorch port of docs/tutorials/04_motion_planning.py)
#
# GPMP2-style trajectory optimization: a trajectory of Point2 poses and
# velocities connected by Gauss-Markov GP motion priors, pulled away from
# obstacles by hinge costs on a signed distance field (SDF), with boundary
# costs pinning start and goal. `MotionPlanner` bundles the objective, the
# optimizer and the layer.
#
# Run: `python docs/tutorials_torch/04_motion_planning.py [--device cpu]`

# %%
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.motion_planning import MotionPlanner

parser = argparse.ArgumentParser()
parser.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
DEVICE = config.resolve_device(parser.parse_args().device)
F64 = dict(dtype=torch.float64, device=DEVICE)

# %% [markdown]
# ## An SDF with one circular obstacle in the middle

# %%
MAP_SIZE, CELL = 20, 0.2
xs = (torch.arange(MAP_SIZE, **F64) + 0.5) * CELL
gy, gx = torch.meshgrid(xs, xs, indexing="ij")  # gx varies along a row
center, radius = torch.tensor([2.1, 1.7], **F64), 0.5
sdf = torch.linalg.vector_norm(torch.stack([gx, gy], -1) - center, dim=-1) - radius  # (H, W), positive outside

# %% [markdown]
# ## Plan

# %%
planner = MotionPlanner(
    map_size=MAP_SIZE,
    epsilon_dist=0.35,  # hinge activation distance
    total_time=2.0,
    collision_weight=30.0,
    Qc_inv=[[1.0, 0.0], [0.0, 1.0]],
    num_time_steps=14,
    max_iterations=30,
    dtype=torch.float64,
    device=DEVICE,
)
start = torch.tensor([[0.3, 0.3]], **F64)
goal = torch.tensor([[3.7, 3.7]], **F64)
values, info = planner.solve(start, goal, sdf_origin=torch.zeros((1, 2), **F64), sdf_data=sdf[None],
                             cell_size=torch.full((1, 1), CELL, **F64))
traj = planner.trajectory(values)[0].cpu()  # (T+1, 2)
print("trajectory:")
for p in traj.tolist():
    print(f"  ({p[0]:.2f}, {p[1]:.2f})")

# %% [markdown]
# The straight line from start to goal passes through the obstacle; the
# planned trajectory must detour around it while staying smooth (GP prior)
# and hitting the endpoints (boundary costs).

# %%
clearance = torch.linalg.vector_norm(traj - center.cpu(), dim=-1) - radius
print("min clearance along trajectory:", float(clearance.min()))
assert float(clearance.min()) > 0.0, "trajectory must avoid the obstacle"
torch.testing.assert_close(traj[0], start[0].cpu(), atol=1e-3, rtol=0)
torch.testing.assert_close(traj[-1], goal[0].cpu(), atol=1e-3, rtol=0)
print("tutorial 04 OK")
