"""Bundle adjustment (the port of examples/bundle_adjustment.py).

A synthetic scene or a BAL file, Reprojection costs with an optional
Huber loss, LM on the block-sparse (mixed-dof) Cholesky or the dense
solver. Runs on the card unless --device cpu is given.

    python examples_torch/bundle_adjustment.py [--bal FILE] [--cameras 8] [--points 40] [--no-robust]
        [--linearization sparse|dense] [--device cpu]
"""

import argparse
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import theseus_tpu_torch as tt
from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective, load_bal, synthetic_ba


def run(bal_path=None, cameras=8, points=40, robust=True, linearization="sparse", device=None):
    """(initial, final) mean error metric and the solve's info."""
    dev = config.resolve_device(device)
    if bal_path:
        prob = load_bal(bal_path, device=dev)
    else:
        prob = synthetic_ba(num_cameras=cameras, num_points=points, outlier_fraction=0.05 if robust else 0.0,
                            visibility=0.5, device=dev)
    obj, _, _ = build_ba_objective(prob, device=dev, robust_loss_cls=tt.HuberLoss if robust else None,
                                   log_loss_radius=math.log(1.0))
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True,
                                                  linearization=linearization))
    init = ba_values(prob)
    init_err = obj.error_metric(values=obj.default_values(init))
    values, info = layer.forward(init)
    final_err = obj.error_metric(values=values)
    print(f"cameras={prob.num_cameras} points={prob.num_points} observations={len(prob.obs_cam)} "
          f"solver={linearization}")
    print(f"error: {float(init_err.mean()):.4f} -> {float(final_err.mean()):.6f} (status {info.status.cpu().numpy()})")
    return float(init_err.mean()), float(final_err.mean()), info


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bal", default=None, help="path to a BAL-format file")
    p.add_argument("--cameras", type=int, default=8)
    p.add_argument("--points", type=int, default=40)
    p.add_argument("--no-robust", action="store_true")
    p.add_argument("--linearization", default="sparse", choices=["dense", "sparse"])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    run(a.bal, a.cameras, a.points, not a.no_robust, a.linearization, a.device)


if __name__ == "__main__":
    main()
