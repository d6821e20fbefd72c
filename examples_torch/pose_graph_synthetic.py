"""Synthetic SE3 pose-graph optimization with a learned robust-loss radius (the port of examples/pose_graph_synthetic.py).

The outer loop learns the Welsch log-radius of the robust Between costs,
by gradient descent through the implicit backward of the inner LM solve,
so that the solve best rejects two corrupted loop closures. The
corruption is drawn from a CPU torch.Generator seeded 7. Runs on the card
unless --device cpu is given.

    python examples_torch/pose_graph_synthetic.py [--n-poses 64] [--batch 8] [--epochs 10]
        [--linearization dense|sparse] [--device cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

import theseus_tpu_torch as tt
from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph
from theseus_tpu_torch.utils.timer import device_sync


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-poses", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--linearization", default="dense", choices=["dense", "sparse"])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    dev = config.resolve_device(a.device)
    n, batch, f64 = a.n_poses, a.batch, torch.float64

    gt, edges, meas, init = synthetic_pose_graph(n, batch, dtype=f64, device=dev, meas_noise=0.02)
    # corrupt the last two loop closures: outliers
    gen = torch.Generator().manual_seed(7)
    bad = se3.exp(1.5 * torch.randn((2, batch, 6), generator=gen, dtype=f64).to(dev))
    meas = torch.cat([meas[:-2], se3.compose(meas[-2:], bad)])

    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=f64, device=dev, robust_loss_cls=tt.WelschLoss,
                                 log_loss_radius=0.0)
    opt = tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True, linearization=a.linearization)
    layer = tt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    state = co.pack(values, batch)
    gt_flat = gt.permute(1, 0, 2, 3).reshape(batch, -1)

    def loss_fn(log_radius):
        vals = dict(values)
        vals["log_loss_radius"] = log_radius * torch.ones((1, 1), dtype=f64, device=dev)
        carry = layer.solve_state(state, co.build_aux(vals, batch), "implicit", opt.opts)
        est = carry["state"]["SE3"].permute(1, 0, 2, 3).reshape(batch, -1)
        return torch.mean((est - gt_flat) ** 2)

    log_radius = torch.tensor(2.0, dtype=f64, device=dev, requires_grad=True)
    for ep in range(a.epochs):
        t0 = time.perf_counter()
        loss = loss_fn(log_radius)
        (g,) = torch.autograd.grad(loss, [log_radius])
        with torch.no_grad():
            log_radius -= 5.0 * g
        device_sync(dev)
        print(f"epoch {ep:2d} loss {float(loss.detach()):.6f} log_radius {float(log_radius.detach()):.4f} "
              f"({time.perf_counter() - t0:.2f}s)")


if __name__ == "__main__":
    main()
