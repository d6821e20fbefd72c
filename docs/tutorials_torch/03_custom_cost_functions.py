# %% [markdown]
# # Tutorial 3: Custom cost functions
#
# (the PyTorch port of docs/tutorials/03_custom_cost_functions.py)
#
# Two ways to add residuals:
#
# 1. **AutoDiffCostFunction**: write the residual for one instance and one
#    batch element; tangent-space jacobians come from torch.func, and the
#    compiler maps it over instances and batch with vmap.
# 2. **Subclassing CostFunction with analytic jacobians**: `error_impl`
#    and `jacobians_impl` take whole stacked buckets, every optim operand
#    (K, B, ...) and every aux (K, B, ...) or shared (B, ...); torch
#    broadcasting does the rest. `jacobians_impl` returns right-tangent
#    jacobians: d r / d delta at delta = 0 of r(x retract delta).
#
# `check_jacobians` verifies analytic jacobians against autodiff.
#
# Run: `python docs/tutorials_torch/03_custom_cost_functions.py [--device cpu]`

# %%
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch

import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import so3
from theseus_tpu_torch.utils import check_jacobians

parser = argparse.ArgumentParser()
parser.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
DEVICE = config.resolve_device(parser.parse_args().device)

# %% [markdown]
# ## A custom SO3 cost with analytic jacobians
#
# Residual: log(R_target^-1 R), the tangent distance to a target rotation.
# Its right-tangent jacobian with respect to R is the jacobian of the log,
# which `so3.jlog` gives analytically; we verify it numerically.

# %%


class SO3Prior(tt.CostFunction):
    has_analytic_jacobians = True

    def __init__(self, rot, target, weight=None, name=None):
        super().__init__([rot], [tt.as_variable(target, name="so3_target")], weight, name)

    def dim(self):
        return 3

    def error_impl(self, optim, aux):
        (r,) = optim
        (target,) = aux
        return so3.log(so3.compose(so3.inverse(target), r))

    def jacobians_impl(self, optim, aux):
        (r,) = optim
        (target,) = aux
        (jac,), err = so3.jlog(so3.compose(so3.inverse(target), r))
        return [jac], err


rot = tt.SO3(name="rot")
target = so3.exp(torch.tensor([[0.3, -0.2, 0.5]], dtype=torch.float64))
cost = SO3Prior(rot, target, tt.ScaleCostWeight(1.0), name="prior")
check_jacobians(cost, num_checks=3, tol=1e-6, device=DEVICE)
print("analytic jacobians verified against autodiff")

# %% [markdown]
# ## Using it

# %%
obj = tt.Objective(dtype=torch.float64, device=DEVICE)
obj.add(cost)
layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=6))
sol, info = layer.forward({"rot": torch.eye(3, dtype=torch.float64, device=DEVICE)[None]})
torch.testing.assert_close(sol["rot"].cpu(), target, atol=1e-6, rtol=0)

# %% [markdown]
# ## Robust costs
#
# Wrap any cost with a robust loss (Welsch, Huber, GemanMcClure, Hinge) to
# downweight outliers; `GNCRobustCostFunction` adds graduated
# non-convexity annealing.

# %%
x = tt.Vector(1, name="x")
data = torch.cat([torch.full((1, 9), 1.0), torch.full((1, 1), 50.0)], dim=-1)  # one outlier


def res(optim, aux):
    (x,) = optim
    (d,) = aux
    return x - d


base = tt.AutoDiffCostFunction([x], 10, res, aux_vars=[tt.Variable(data, name="data")], name="fit")
robust = tt.RobustCostFunction(base, tt.WelschLoss, torch.zeros((1, 1)), flatten_dims=True, name="fit_robust")
obj2 = tt.Objective(device=DEVICE)
obj2.add(robust)
opt2 = tt.LevenbergMarquardt(obj2, max_iterations=20, adaptive_damping=True)
sol2, _ = tt.TheseusLayer(opt2).forward({"x": torch.ones((1, 1), device=DEVICE)})
print("robust estimate (true inliers at 1.0):", sol2["x"])
assert abs(float(sol2["x"][0, 0]) - 1.0) < 0.1
print("tutorial 03 OK")
