# %% [markdown]
# # Tutorial 2: Differentiating through the layer
#
# (the PyTorch port of docs/tutorials/02_differentiating_theseus_layer.py)
#
# The point of a *differentiable* NLLS layer: outer-loop parameters (data,
# weights, measurement models) receive gradients THROUGH the inner
# optimization. Four backward modes:
#
# - **unroll**: autograd through every inner iteration;
# - **implicit**: the implicit-function-theorem adjoint, one detached
#   Gauss-Newton step at the solution carries the whole gradient;
# - **truncated**: autograd through the last K iterations only;
# - **dlm**: direct loss minimization via a perturbed objective.
#
# We fit y = a*x^2 + b and learn the data by gradient descent.
#
# Run: `python docs/tutorials_torch/02_differentiating_theseus_layer.py [--device cpu]`

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

xs = torch.linspace(-1.0, 1.0, 20, dtype=torch.float64, device=DEVICE)[None]
a_true, b_true = 3.0, -1.0
ys_clean = a_true * xs**2 + b_true

ab = tt.Vector(2, name="ab")
x_var = tt.Variable(xs, name="xs")
y_var = tt.Variable(ys_clean, name="ys")


def residual(optim, aux):
    (ab,) = optim
    x, y = aux
    return ab[0] * x**2 + ab[1] - y


obj = tt.Objective(dtype=torch.float64, device=DEVICE)
obj.add(tt.AutoDiffCostFunction([ab], 20, residual, aux_vars=[x_var, y_var], name="fit"))
opt = tt.GaussNewton(obj, max_iterations=8)
layer = tt.TheseusLayer(opt)

# %% [markdown]
# ## Gradients by autograd
#
# Pack values into state and aux and call `layer.solve_state`; the solved
# state carries autograd history back to the aux as the mode defines. Here
# the outer parameter is the observation vector `ys`; the outer loss asks
# the recovered `a` to hit a target value.

# %%
co = obj.compile()


def outer_loss(ys, mode):
    values = {"ab": torch.zeros((1, 2), dtype=torch.float64, device=DEVICE), "xs": xs, "ys": ys}
    state, aux = co.pack(values, 1), co.build_aux(values, 1)
    carry = layer.solve_state(state, aux, mode, opt.opts, backward_num_iterations=3)
    ab_star = co.unpack(carry["state"])["ab"]
    return (ab_star[0, 0] - 5.0) ** 2  # want the fitted a to equal 5


def value_and_grad(ys, mode):
    y = ys.detach().requires_grad_()
    loss = outer_loss(y, mode)
    (g,) = torch.autograd.grad(loss, y)
    return loss.detach(), g


for mode in ("unroll", "implicit", "truncated", "dlm"):
    _, g = value_and_grad(ys_clean, mode)
    print(f"{mode:10s} d loss/d ys[0, :3] = {g[0, :3].tolist()}")

# %% [markdown]
# All four agree on this zero-residual problem. Now use the gradient: learn
# observations that make the inner solve produce a = 5.

# %%
ys = ys_clean
for i in range(40):
    loss, g = value_and_grad(ys, "implicit")
    ys = ys - 0.5 * g
print("final outer loss:", float(loss))
assert float(loss) < 1e-3
print("tutorial 02 OK")
