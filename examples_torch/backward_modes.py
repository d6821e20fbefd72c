"""Compare backward modes (the port of examples/backward_modes.py).

Gradients of the solution of a curve fit with respect to a data parameter
under unroll / implicit / truncated / dlm, timed, against finite
differences. Runs on the card unless --device cpu is given.

    python examples_torch/backward_modes.py [--device cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.timer import device_sync

MODES = ("unroll", "implicit", "truncated", "dlm")


def problem(dtype=torch.float32, device=None, batch=2, npts=25):
    """(layer, loss(mode, theta)): the curve fit of the JAX script, the loss
    sum(ab*^2) of the solution fit to theta * y (4 backward iterations)."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch, npts))
    ab_true = rng.uniform(0.5, 2.0, (batch, 2))
    y = ab_true[:, :1] * x ** 2 + ab_true[:, 1:]

    ab = tt.Vector(2, name="ab")
    xv, yv = tt.Variable(x, name="x"), tt.Variable(y, name="y")

    def err_fn(optim, aux):
        (ab,) = optim
        xx, yy = aux
        return yy - (ab[0] * xx ** 2 + ab[1])

    obj = tt.Objective(dtype=dtype, device=device)
    obj.add(tt.AutoDiffCostFunction([ab], npts, err_fn, aux_vars=[xv, yv]))
    opt = tt.GaussNewton(obj, max_iterations=12)
    layer = tt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values({"ab": torch.zeros((batch, 2), dtype=dtype, device=obj.device)})
    state = co.pack(values, batch)
    y_t = torch.as_tensor(y, dtype=dtype, device=obj.device)

    def loss(mode, theta):
        vals = dict(values)
        vals["y"] = theta * y_t
        carry = layer.solve_state(state, co.build_aux(vals, batch), mode, opt.opts, 4)
        return torch.sum(co.unpack(carry["state"])["ab"] ** 2)

    return layer, loss


def gradients(loss, theta=1.17, dtype=torch.float32, device=None):
    """{mode: d loss / d theta} and the central difference at h = 1e-3."""
    out = {}
    for mode in MODES:
        th = torch.tensor(theta, dtype=dtype, device=device, requires_grad=True)
        (g,) = torch.autograd.grad(loss(mode, th), [th])
        out[mode] = g
    h = 1e-3
    with torch.no_grad():
        th = torch.tensor(theta, dtype=dtype, device=device)
        out["fd"] = (loss("implicit", th + h) - loss("implicit", th - h)) / (2 * h)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    dev = config.resolve_device(args.device)

    _, loss = problem(device=dev)
    g = gradients(loss, device=dev)
    print(f"finite difference reference: {float(g['fd']):+.6f}")
    for mode in MODES:
        th = torch.tensor(1.17, device=dev, requires_grad=True)
        torch.autograd.grad(loss(mode, th), [th])  # warm-up
        device_sync(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            th = torch.tensor(1.17, device=dev, requires_grad=True)
            (gm,) = torch.autograd.grad(loss(mode, th), [th])
        device_sync(dev)
        dt = (time.perf_counter() - t0) / 10
        print(f"{mode:10s} grad {float(gm):+.6f}  ({dt * 1e3:.2f} ms/grad)")


if __name__ == "__main__":
    main()
