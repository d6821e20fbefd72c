"""Quadratic curve fitting with a differentiable NLLS layer (the port of examples/simple_example.py).

Fit y = a x^2 + b per batch element with Gauss-Newton, then learn a data
scale by differentiating through the solve (implicit mode). Runs on the
card unless --device cpu is given.

    python examples_torch/simple_example.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from examples_torch import _config
from theseus_tpu_torch import config


def data(batch=4, npts=40, seed=0):
    """(x, y, ab_true) in numpy float64, from the JAX script's RandomState."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (batch, npts))
    ab_true = rng.uniform(0.5, 2.0, (batch, 2))
    return x, ab_true[:, :1] * x ** 2 + ab_true[:, 1:], ab_true


def build(x, y, iters=15, dtype=torch.float32, device=None):
    """(objective, layer) of the curve fit, ab the one optimization variable."""
    ab = tt.Vector(2, name="ab")
    xv, yv = tt.Variable(x, name="x"), tt.Variable(y, name="y")

    def err_fn(optim, aux):
        (ab,) = optim
        xx, yy = aux
        return yy - (ab[0] * xx ** 2 + ab[1])

    obj = tt.Objective(dtype=dtype, device=device)
    obj.add(tt.AutoDiffCostFunction([ab], x.shape[1], err_fn, aux_vars=[xv, yv]))
    return obj, tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=iters))


def outer_grad(obj, layer, y, theta=1.0, mode="implicit", bwd_iters=5):
    """d/dtheta of sum(ab*) with the data scaled by theta."""
    co = obj.compile()
    batch = y.shape[0]
    th = torch.tensor(theta, dtype=obj.dtype, device=obj.device, requires_grad=True)
    vals = obj.default_values({"ab": torch.zeros((batch, 2), dtype=obj.dtype, device=obj.device),
                               "y": th * torch.as_tensor(y, dtype=obj.dtype, device=obj.device)})
    carry = layer.solve_state(co.pack(vals, batch), co.build_aux(vals, batch), mode, layer.optimizer.opts, bwd_iters)
    (g,) = torch.autograd.grad(torch.sum(co.unpack(carry["state"])["ab"]), [th])
    return g


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    dev = config.resolve_device(args.device)

    x, y, ab_true = data()
    obj, layer = build(x, y, device=dev)
    values, info = layer.forward({"ab": torch.zeros((x.shape[0], 2), device=dev)})
    print("estimated a, b:\n", values["ab"].cpu().numpy())
    print("true      a, b:\n", ab_true)
    print("status:", info.status.cpu().numpy(), "iters:", info.converged_iter.cpu().numpy())
    print("outer grad:", float(outer_grad(obj, layer, y)))


if __name__ == "__main__":
    main()
