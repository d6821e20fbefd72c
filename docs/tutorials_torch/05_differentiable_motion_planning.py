# %% [markdown]
# # Tutorial 5: Differentiable motion planning
#
# (the PyTorch port of docs/tutorials/05_differentiable_motion_planning.py)
#
# The planner of tutorial 4 is differentiable, so its *parameters* can be
# learned. Here we learn the scalar collision weight so that planned
# trajectories keep a desired clearance from obstacles.
#
# Run: `python docs/tutorials_torch/05_differentiable_motion_planning.py [--device cpu]`

# %%
import argparse
import math
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

MAP_SIZE, CELL = 16, 0.25
planner = MotionPlanner(
    map_size=MAP_SIZE,
    epsilon_dist=0.4,
    total_time=2.0,
    collision_weight=5.0,
    Qc_inv=[[1.0, 0.0], [0.0, 1.0]],
    num_time_steps=10,
    max_iterations=6,
    dtype=torch.float64,
    device=DEVICE,
    learnable_collision_weight=True,  # exposes the input "collision_w"
)
obj = planner.objective
co = obj.compile()
opts = planner.optimizer.opts
layer = planner.layer

# one circular obstacle on the diagonal
xs = (torch.arange(MAP_SIZE, **F64) + 0.5) * CELL
gy, gx = torch.meshgrid(xs, xs, indexing="ij")
center, radius = torch.tensor([2.1, 1.7], **F64), 0.45
sdf = (torch.linalg.vector_norm(torch.stack([gx, gy], -1) - center, dim=-1) - radius)[None]
start, goal = torch.tensor([[0.4, 0.4]], **F64), torch.tensor([[3.6, 3.6]], **F64)
TARGET_CLEARANCE = 0.3

# %% [markdown]
# ## The outer loss
#
# Solve the planning problem as a function of the log collision weight;
# penalize the shortfall of the trajectory's minimum obstacle clearance
# below the target. Gradients flow through the truncated inner solve.

# %%
init = planner.straight_line_initialization(start, goal)


def outer_loss(log_w):
    values = dict(init)
    values.update(start=start, goal=goal, sdf_origin=torch.zeros((1, 2), **F64), sdf_data=sdf,
                  cell_size=torch.full((1, 1), CELL, **F64), collision_w=torch.exp(log_w) * torch.ones((1, 1), **F64))
    values = obj.default_values(values)
    state, aux = co.pack(values, 1), co.build_aux(values, 1)
    carry = layer.solve_state(state, aux, "truncated", opts, 1)
    sol = co.unpack(carry["state"])
    traj = torch.stack([sol[f"pose_{i}"][0] for i in range(obj.num_time_steps + 1)])
    clearance = torch.linalg.vector_norm(traj - center, dim=-1) - radius
    soft_min = -torch.logsumexp(-20.0 * clearance, dim=0) / 20.0
    return torch.relu(TARGET_CLEARANCE - soft_min) ** 2


def value_and_grad(log_w):
    w = log_w.detach().requires_grad_()
    loss = outer_loss(w)
    (g,) = torch.autograd.grad(loss, w)
    return loss.detach(), g


log_w = torch.tensor(math.log(5.0), **F64)
for i in range(12):
    loss, g = value_and_grad(log_w)
    log_w = log_w - 2.0 * g
    if i % 3 == 0 or i == 11:
        print(f"step {i:2d}  loss {float(loss):.5f}  w = {float(torch.exp(log_w)):.2f}")

final_loss = float(value_and_grad(log_w)[0])
print("final clearance-shortfall loss:", final_loss)
assert final_loss < 1e-3, "the learned weight must reach the target clearance"
print("tutorial 05 OK")
