"""First-order manifold optimization of an SE2 inverse problem (the port of examples/se2_inverse.py).

Solve min_x1 || local(x1^-1, x2) ||^2 with a gradient optimizer whose
updates are retraction-based: Adam on the tangent space through
`lie_optimizer` (the default), or bare manifold SGD (`manifold_update`,
--euclidean, as the JAX script takes it). x1 and x2 are drawn from a CPU
torch.Generator seeded 0. Runs on the card unless --device cpu is
given.

    python examples_torch/se2_inverse.py [--iters 1000] [--euclidean] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import SE2, se2
from theseus_tpu_torch.optim.manifold_optax import lie_optimizer, manifold_update


def loss_fn(x1, x2):
    err = SE2.local(se2.inverse(x1), x2)
    return torch.sum(err ** 2)


def draw(seed=0, device=None):
    """(x1, x2): two SE2 elements (1, 4) in float64."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(SE2.randn(1, generator=gen, dtype=torch.float64, device=device) for _ in range(2))


def run(x1, x2, num_iters=1000, use_lie_tangent=True, verbose=True):
    """The fit from x1 toward x2^-1; returns (final loss, x1)."""
    params = {"x1": x1.detach().clone()}
    if use_lie_tangent:
        tx = lie_optimizer({"x1": SE2}, lambda ps: torch.optim.Adam(ps, lr=2e-1))
        state = tx.init(params)
    for i in range(num_iters):
        x = params["x1"].detach().requires_grad_(True)
        val = loss_fn(x, x2)
        (g,) = torch.autograd.grad(val, [x])
        if use_lie_tangent:
            updates, state = tx.update({"x1": g}, state, params)
            params = tx.apply(params, updates)
        else:
            params = {"x1": manifold_update(SE2, params["x1"], g, 0.2)}
        if verbose and i % 100 == 0:
            cs = params["x1"][0, 2:]
            print(f"iter {i:04d}: loss {float(val.detach()):.10f}  cos^2+sin^2 {float(torch.sum(cs ** 2)):.10f}")
    final = float(loss_fn(params["x1"], x2))
    cs = params["x1"][0, 2:]
    unit = float(torch.sum(cs ** 2))
    if verbose:
        print(f"final: loss {final:.10f}  cos^2+sin^2 {unit:.10f}")
    # the retraction-based update keeps the rotation on the manifold exactly
    assert abs(unit - 1.0) < 1e-5, "rotation left the SE2 manifold"
    return final, params["x1"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--euclidean", action="store_true", help="ablation: bare manifold SGD instead of Adam")
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    x1, x2 = draw(0, config.resolve_device(a.device))
    return run(x1, x2, num_iters=a.iters, use_lie_tangent=not a.euclidean)[0]


if __name__ == "__main__":
    main()
