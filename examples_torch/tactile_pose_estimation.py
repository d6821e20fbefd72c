"""Tactile pose estimation from pushing data (the port of examples/tactile_pose_estimation.py).

Estimate a planar object's trajectory from effector motion capture and
tactile (moving-frame) measurements, with quasi-static pushing dynamics
and contact constraints; then run a few outer-loop steps learning the
measurement model by differentiating through the solve. The models and
the features are drawn from CPU torch.Generators seeded 0. Runs on the
card unless --device cpu is given.

    python examples_torch/tactile_pose_estimation.py [--time-steps 5] [--inner-iters 5] [--outer-steps 3] [--device cpu]
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
from theseus_tpu_torch.embodied import occupancy_to_sdf
from theseus_tpu_torch.lie import se2
from theseus_tpu_torch.utils.examples.tactile_pose_estimation import TactilePoseEstimator, TactileTrainer


def synthetic_push(est, dtype=torch.float64, device=None):
    """A straight +x push, the effector 3 cm behind the object: (inputs,
    obj_gt (T, 4), eff_gt (T, 4))."""
    t = est.time_steps
    xs = torch.linspace(0.1, 0.2, t, dtype=dtype, device=device)
    obj_gt = torch.stack([xs, torch.full_like(xs, 0.16), torch.ones_like(xs), torch.zeros_like(xs)], dim=-1)
    eff_gt = obj_gt.clone()
    eff_gt[:, 0] -= 0.03
    occ = np.zeros((32, 32))
    occ[12:20, 12:20] = 1.0
    sdf = occupancy_to_sdf(occ, 0.01)
    inputs = {"obj_start_pose": obj_gt[:1], "sdf_data": torch.as_tensor(sdf, dtype=dtype, device=device)[None]}
    for i in range(t):
        inputs[f"motion_capture_{i}"] = eff_gt[i][None]
        inputs[f"obj_pose_{i}"] = obj_gt[0][None]
        inputs[f"eff_pose_{i}"] = eff_gt[i][None]
    for a, b in est.pairs:
        rel = se2.compose(se2.inverse(se2.compose(se2.inverse(obj_gt[a]), eff_gt[a])),
                          se2.compose(se2.inverse(obj_gt[b]), eff_gt[b]))
        inputs[f"nn_measurement_{a}_{b}"] = rel[None]
    return inputs, obj_gt, eff_gt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--time-steps", type=int, default=5)
    p.add_argument("--inner-iters", type=int, default=5)
    p.add_argument("--outer-steps", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    dev = config.resolve_device(a.device)

    est = TactilePoseEstimator(time_steps=a.time_steps, max_iterations=a.inner_iters, device=dev)
    inputs, obj_gt, _ = synthetic_push(est, device=dev)

    # 1) pure estimation with ground-truth tactile measurements
    values, info = est.forward(inputs)
    err = [float(torch.linalg.norm(values[f"obj_pose_{i}"][0, :2] - obj_gt[i, :2])) for i in range(a.time_steps)]
    print("estimation: per-step position error " + " ".join(f"{e:.4f}" for e in err))
    assert bool((info.status != tt.NonlinearOptimizerStatus.FAIL).all())

    # 2) outer loop: learn the measurement network from the tracking loss
    feat_dim = 8
    trainer = TactileTrainer(est, feature_dim=feat_dim, generator=torch.Generator().manual_seed(0), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    features = {i: torch.randn((1, feat_dim), generator=gen, dtype=torch.float64).to(dev) for i in range(a.time_steps)}
    for step in range(a.outer_steps):
        loss = trainer.step(inputs, features, obj_gt)
        print(f"outer step {step}: tracking loss {loss:.6f}")


if __name__ == "__main__":
    main()
