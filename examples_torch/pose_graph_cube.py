"""Pose-graph optimization on a cube trajectory with outlier loop closures: plain LM against robust (Welsch) against GNC-annealed robust (the port of examples/pose_graph_cube.py).

Poses walk the 12 edges of a unit cube, with odometry edges, correct loop
closures, and a fraction of gross-outlier closures. The robust and GNC
solves should be unaffected by the outliers; the plain solve should
degrade. The Gaussian noise of the measurements and of the initialization
comes from a CPU torch.Generator (`draw_noise`); the outliers from the
JAX script's numpy RandomState. Runs on the card unless --device cpu is
given.

    python examples_torch/pose_graph_cube.py [--outlier-frac 0.3] [--n-per-edge 3] [--device cpu]
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
from theseus_tpu_torch.lie import se3

MODES = ("none", "welsch", "gnc")


def cube_trajectory(n_per_edge=4, dtype=torch.float32, device="cpu"):
    """Ground-truth poses (N, 1, 3, 4) on a closed tour of the cube's 8
    corners; each faces its direction of motion."""
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 1, 1], [1, 1, 1], [1, 0, 1], [0, 0, 1]], dtype=np.float64)
    tour = list(range(8)) + [0]
    pts = []
    for a, b in zip(tour[:-1], tour[1:]):
        for s in np.linspace(0, 1, n_per_edge, endpoint=False):
            pts.append(corners[a] * (1 - s) + corners[b] * s)
    pts = np.asarray(pts)
    n = len(pts)
    poses = []
    for i in range(n):
        d = pts[(i + 1) % n] - pts[i]
        d = d / (np.linalg.norm(d) + 1e-12)
        up = np.array([0.0, 0.0, 1.0])
        if abs(d @ up) > 0.9:
            up = np.array([0.0, 1.0, 0.0])
        x = d
        z = np.cross(x, up)
        z /= np.linalg.norm(z)
        y = np.cross(z, x)
        poses.append(np.concatenate([np.stack([x, y, z], axis=1), pts[i][:, None]], axis=1))
    return torch.as_tensor(np.stack(poses), dtype=dtype, device=device)[:, None]


def edges_of(n):
    """The odometry ring and a closure from every third pose across the cube."""
    closures = [(i, (i + n // 2) % n) for i in range(0, n, 3)]
    return [(i, (i + 1) % n) for i in range(n)] + closures, closures


def draw_noise(n, seed=0, init_seed=99):
    """(measurement noise (E, 1, 6), initialization noise (N, 1, 6)):
    standard normal tangents, float64, from CPU generators."""
    edges, _ = edges_of(n)
    meas = torch.randn((len(edges), 1, 6), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    init = torch.randn((n, 1, 6), generator=torch.Generator().manual_seed(init_seed), dtype=torch.float64)
    return meas, init


def build_problem(gt, outlier_frac, seed, robust, noise, dtype=torch.float32, device=None):
    """(objective, outlier count): measurements gt_i^-1 gt_j perturbed by
    exp(0.02 noise), a deterministic fraction of the closures replaced by
    gross outliers; a prior on pose 0; each edge plain, Welsch or
    GNC-GemanMcClure on its whole residual norm."""
    n = gt.shape[0]
    rng = np.random.RandomState(seed)
    edges, closures = edges_of(n)
    e = torch.as_tensor(edges)
    gt = gt.to(dtype)
    rel = se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])
    meas = se3.compose(rel, se3.exp(0.02 * noise.to(dtype=dtype, device=gt.device)))
    n_out = max(1, int(round(outlier_frac * len(closures)))) if outlier_frac > 0 else 0
    out_idx = [n + int(i) for i in rng.choice(len(closures), size=n_out, replace=False)]
    if out_idx:
        bad = se3.exp(torch.as_tensor(rng.uniform(-2, 2, (len(out_idx), 1, 6)), dtype=dtype, device=gt.device))
        meas = meas.clone()
        meas[torch.as_tensor(out_idx)] = bad

    obj = tt.Objective(dtype=dtype, device=device)
    poses = [tt.SE3(name=f"pose_{i}") for i in range(n)]
    obj.add(tt.Local(poses[0], gt[0], tt.ScaleCostWeight(torch.tensor(100.0, dtype=dtype)), name="prior"))
    radius = tt.Variable(torch.log(torch.full((1, 1), 0.5, dtype=dtype)), name="log_radius")
    mu_var = tt.Variable(torch.tensor([[1.0]], dtype=dtype), name="mu")
    for ei, (i, j) in enumerate(edges):
        base = tt.Between(poses[i], poses[j], meas[ei], name=f"edge_{ei}")
        if robust == "welsch":
            # flatten_dims=False: the loss gates the whole edge residual norm,
            # the right granularity for outlier loop closures
            obj.add(tt.RobustCostFunction(base, tt.WelschLoss, radius, flatten_dims=False, name=f"r_{ei}"))
        elif robust == "gnc":
            obj.add(tt.GNCRobustCostFunction(base, tt.GemanMcClureLoss, radius, mu_var, flatten_dims=False,
                                             name=f"r_{ei}"))
        else:
            obj.add(base)
    return obj, len(out_idx)


def ate(values, gt):
    """Mean translational error against the ground truth."""
    return float(np.mean([float(torch.linalg.norm(values[f"pose_{i}"][0, :, 3] - gt[i, 0, :, 3]))
                          for i in range(gt.shape[0])]))


def solve(obj, init_vals, gnc=False):
    """LM (60 iterations, adaptive damping); GNC anneals mu 1e5 -> 1."""
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=60, adaptive_damping=True))
    values = dict(init_vals)
    if gnc:
        for mu in (1e5, 100.0, 10.0, 1.0):
            values["mu"] = torch.tensor([[mu]], dtype=obj.dtype, device=obj.device)
            values, info = layer.forward(values)
    else:
        values, info = layer.forward(values)
    return values, info


def run(outlier_frac=0.3, n_per_edge=3, seed=0, noise=None, dtype=torch.float32, device=None, verbose=True):
    """{mode: ATE} of the three solves; `noise` as `draw_noise` returns it."""
    dev = config.resolve_device(device)
    gt = cube_trajectory(n_per_edge, dtype, dev)
    n = gt.shape[0]
    meas_noise, init_noise = noise if noise is not None else draw_noise(n, seed)
    init = se3.compose(gt, se3.exp(0.1 * init_noise.to(dtype=dtype, device=dev)))
    init_vals = {f"pose_{i}": init[i] for i in range(n)}
    results = {}
    for mode in MODES:
        obj, n_out = build_problem(gt, outlier_frac, seed, mode, meas_noise, dtype, dev)
        values, info = solve(obj, init_vals, gnc=(mode == "gnc"))
        results[mode] = ate(values, gt)
        if verbose:
            print(f"{mode:7s}: ATE {results[mode]:.4f}  ({n_out} outlier closures, status "
                  f"{info.status.cpu().numpy()})")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--outlier-frac", type=float, default=0.3)
    p.add_argument("--n-per-edge", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    results = run(a.outlier_frac, a.n_per_edge, a.seed, device=a.device)
    assert results["welsch"] < 0.8 * results["none"], "robust solve should beat plain GN under outliers"
    assert results["gnc"] < 0.8 * results["none"], "GNC solve should beat plain GN under outliers"
    print("ok: robust/GNC suppress outlier loop closures")


if __name__ == "__main__":
    main()
