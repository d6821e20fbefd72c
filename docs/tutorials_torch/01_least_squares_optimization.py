# %% [markdown]
# # Tutorial 1: Nonlinear least-squares optimization
#
# (the PyTorch port of docs/tutorials/01_least_squares_optimization.py)
#
# We fit a curve y = a * exp(b * x) to noisy data, the classic NLLS demo,
# and tour the optimizer options: Gauss-Newton, Levenberg-Marquardt and
# Dogleg, damping, and the info object.
#
# Run: `python docs/tutorials_torch/01_least_squares_optimization.py [--device cpu]`

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

gen = torch.Generator().manual_seed(0)
a_true, b_true = 2.0, 0.7
xs = torch.linspace(0.0, 1.0, 30)[None]  # (1, N)
ys = a_true * torch.exp(b_true * xs)
ys = ys + 0.01 * torch.randn(ys.shape, generator=gen)  # noisy observations

# %% [markdown]
# ## An AutoDiffCostFunction
#
# The residual is written for one batch element; jacobians come from
# torch.func autodiff in the tangent space (no hand-derived derivatives).
# `dim` is the residual length.

# %%
ab = tt.Vector(2, name="ab")


def residual(optim, aux):
    (ab,) = optim
    x, y = aux
    return ab[0] * torch.exp(ab[1] * x) - y


obj = tt.Objective(device=DEVICE)
obj.add(tt.AutoDiffCostFunction([ab], 30, residual,
                                aux_vars=[tt.Variable(xs, name="xs"), tt.Variable(ys, name="ys")],
                                name="curve_fit"))

# %% [markdown]
# ## Optimizers
#
# - `GaussNewton`: plain GN steps.
# - `LevenbergMarquardt`: damped steps; `adaptive_damping=True` adjusts the
#   damping per batch element from the gain ratio (rejecting bad steps).
# - `Dogleg`: trust-region interpolation between the GN and steepest
#   descent steps.
#
# `linearization="dense"` (the default) materializes the full jacobian;
# `"sparse"` builds block-sparse normal equations and runs the batched
# block-sparse Cholesky on the card's kernels (pose graphs); `"schur"`
# eliminates landmarks in closed form (bundle adjustment).

# %%
init = {"ab": torch.tensor([[1.0, 0.0]], device=DEVICE)}
for opt_cls, kw in [
    (tt.GaussNewton, {}),
    (tt.LevenbergMarquardt, dict(adaptive_damping=True)),
    (tt.Dogleg, {}),
]:
    layer = tt.TheseusLayer(opt_cls(obj, max_iterations=15, **kw))
    sol, info = layer.forward(init)
    print(f"{opt_cls.__name__:20s} ab* = {sol['ab'][0].tolist()}  best_err = {float(info.best_err[0]):.3e}")

# %% [markdown]
# ## The info object
#
# Per-batch status, best error and (optionally) the error history:

# %%
opt = tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True, track_err_history=True)
sol, info = tt.TheseusLayer(opt).forward(init)
print("status:", info.status)
print("err history (first 6):", info.err_history[:6, 0])

assert (sol["ab"][0].cpu() - torch.tensor([a_true, b_true])).abs().max() < 0.1
print("tutorial 01 OK")
