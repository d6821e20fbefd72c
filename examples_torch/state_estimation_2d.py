"""2D state estimation with a learned cost weight and a choice of backward mode (the port of examples/state_estimation_2d.py).

A chain of 2D positions with noisy GPS-like measurements and odometry; the
GPS weight is a learnable scalar trained in an outer loop by
differentiating through the inner Gauss-Newton solve (unroll, implicit,
truncated or dlm). Runs on the card unless --device cpu is given.

    python examples_torch/state_estimation_2d.py [--mode implicit] [--epochs 20] [--device cpu]
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

MODES = ("unroll", "implicit", "truncated", "dlm")


def simulate(batch=8, steps=20, gps_noise=0.4, odo_noise=0.05, seed=0):
    """(gt, gps, odo) in numpy float64, the JAX script's RandomState draws."""
    rng = np.random.RandomState(seed)
    vel = rng.uniform(-0.3, 0.3, (batch, 1, 2))
    gt = np.cumsum(np.repeat(vel, steps, axis=1), axis=1)
    gps = gt + gps_noise * rng.randn(*gt.shape)
    odo = np.diff(gt, axis=1) + odo_noise * rng.randn(batch, steps - 1, 2)
    return gt, gps, odo


def build(steps, gps, odo, weight, device=None):
    """(objective, positions): a Local GPS cost per step weighted by
    `weight`, a Between odometry cost (weight 10) per step pair; float64."""
    obj = tt.Objective(dtype=torch.float64, device=device)
    xs = [tt.Point2(name=f"x_{i}") for i in range(steps)]
    for i in range(steps):
        obj.add(tt.Local(xs[i], gps[:, i], weight, name=f"gps_{i}"))
    ow = tt.ScaleCostWeight(np.asarray(10.0))
    for i in range(steps - 1):
        obj.add(tt.Between(xs[i], xs[i + 1], odo[:, i], cost_weight=ow, name=f"odo_{i}"))
    return obj, xs


def make_loss(mode="implicit", batch=8, steps=20, device=None):
    """loss(log_w): the mean squared error of the solution (10 GN
    iterations, 5 differentiated where the mode asks) to the ground truth,
    with the GPS weight exp(log_w)."""
    gt, gps, odo = simulate(batch, steps)
    w = tt.ScaleCostWeight(np.asarray(1.0), name="gps_weight")
    obj, _ = build(steps, gps, odo, w, device)
    opt = tt.GaussNewton(obj, max_iterations=10)
    layer = tt.TheseusLayer(opt)
    co = obj.compile()
    dev = obj.device
    values = obj.default_values({f"x_{i}": torch.zeros((batch, 2), dtype=torch.float64, device=dev)
                                 for i in range(steps)})
    state = co.pack(values, batch)
    gt_flat = torch.as_tensor(gt.reshape(batch, -1), device=dev)

    def loss_fn(log_w):
        vals = dict(values)
        vals[w.scale.name] = torch.exp(log_w) * torch.ones((1, 1), dtype=torch.float64, device=dev)
        carry = layer.solve_state(state, co.build_aux(vals, batch), mode, opt.opts, 5)
        sol = co.unpack(carry["state"])
        est = torch.cat([sol[f"x_{i}"] for i in range(steps)], dim=-1)
        return torch.mean((est - gt_flat) ** 2)

    return loss_fn


def train(mode="implicit", epochs=20, device=None, verbose=True):
    """Gradient descent on log_w at rate 2; returns the losses."""
    dev = config.resolve_device(device)
    loss_fn = make_loss(mode, device=dev)
    log_w = torch.tensor(0.0, dtype=torch.float64, device=dev, requires_grad=True)
    losses = []
    for ep in range(epochs):
        loss = loss_fn(log_w)
        (g,) = torch.autograd.grad(loss, [log_w])
        with torch.no_grad():
            log_w -= 2.0 * g
        losses.append(float(loss.detach()))
        if verbose and (ep % 5 == 0 or ep == epochs - 1):
            print(f"epoch {ep:3d} loss {losses[-1]:.5f} gps weight {float(torch.exp(log_w.detach())):.4f}")
    return losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="implicit", choices=list(MODES))
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    train(a.mode, a.epochs, a.device)


if __name__ == "__main__":
    main()
