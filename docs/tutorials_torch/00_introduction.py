# %% [markdown]
# # Tutorial 0: An introduction to theseus_tpu_torch
#
# (the PyTorch port of docs/tutorials/00_introduction.py)
#
# theseus_tpu_torch solves **differentiable nonlinear least-squares**
# problems: given manifold-valued variables x and weighted residual "cost
# functions" r_i(x), it minimizes 0.5 * sum_i ||w_i r_i(x)||^2 with a
# second-order optimizer, and the whole solve is differentiable, so it can
# sit inside a learning loop.
#
# The core concepts, bottom-up:
# - **Variable**: a named tensor. Auxiliary variables hold data (targets,
#   measurements); `ManifoldVariable`s are the optimized unknowns and live
#   on a manifold (Vector, Point2/3, SO2/3, SE2/3).
# - **CostFunction**: a residual over optim vars and aux vars, with a
#   CostWeight.
# - **Objective**: the collection of cost functions (the problem graph).
#   It fixes the dtype and the device every solve runs on: the card unless
#   `device="cpu"` is given.
# - **Optimizer + TheseusLayer**: the inner solver and its differentiable
#   module wrapper.
#
# Data has a leading batch dimension B everywhere; batch-1 tensors
# broadcast.
#
# Run: `python docs/tutorials_torch/00_introduction.py [--device cpu]`
# (the default is the card).

# %%
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

import theseus_tpu_torch as tt
from theseus_tpu_torch import config

parser = argparse.ArgumentParser()
parser.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
DEVICE = config.resolve_device(parser.parse_args().device)

# %% [markdown]
# ## Variables
#
# A Variable is a *spec*: a name plus (optionally) a default tensor.
# Per-call data flows through the values dict, so the same Objective can be
# reused with new data without rebuilding anything.

# %%
x = tt.Vector(2, name="x")  # an optimization variable in R^2
target = tt.Variable(torch.tensor([[1.0, 2.0]]), name="target")  # aux data
print(x, target)

# %% [markdown]
# Manifold variables know their group:

# %%
pose = tt.SE3(name="pose")  # 3x4 [R|t] matrices, dof 6
rot = tt.SO3(name="rot")  # 3x3 rotations, dof 3
print(pose.group.name, pose.group.dof, rot.group.shape)

# %% [markdown]
# ## Cost functions and weights
#
# `Local` (the reference's `Difference`) penalizes the tangent-space
# distance between a variable and a target. Weights multiply residuals
# (sqrt-precision convention): `ScaleCostWeight` is a scalar,
# `DiagonalCostWeight` a per-dimension vector.

# %%
cost = tt.Local(x, target, tt.ScaleCostWeight(2.0), name="pull_to_target")
print(cost, "residual dim:", cost.dim())

# %% [markdown]
# ## The Objective and its error

# %%
obj = tt.Objective(device=DEVICE)
obj.add(cost)
values = obj.default_values({"x": torch.zeros((1, 2), device=DEVICE)})
print("error vector:", obj.error(values=values))  # (B, dim)
print("error metric:", obj.error_metric(values=values))  # 0.5 * ||e||^2
print("costs", obj.size_cost_functions(), "variables", obj.size_variables(), "aux", obj.size_aux_vars(),
      "dim", obj.dim())

# %% [markdown]
# ## Solving
#
# Wrap an optimizer in a TheseusLayer and call forward() with input data.
# The solution comes back as a values dict plus an info object.

# %%
opt = tt.GaussNewton(obj, max_iterations=5)
layer = tt.TheseusLayer(opt)
solution, info = layer.forward({"x": torch.zeros((1, 2), device=DEVICE)})
print("x* =", solution["x"], " (target was [1, 2])")
print("converged best error:", info.best_err)

# %% [markdown]
# Batching is automatic: feed (B, ...) tensors and every batch element is
# solved independently.

# %%
solution, info = layer.forward(
    {"x": torch.zeros((3, 2), device=DEVICE), "target": torch.tensor([[1.0, 2], [3, 4], [5, 6]], device=DEVICE)}
)
print("batched solutions:\n", solution["x"])

assert torch.allclose(solution["x"][2].cpu(), torch.tensor([5.0, 6.0]), atol=1e-6)
print("tutorial 00 OK")
