"""Gaussian belief propagation on a loopy SE2 pose graph (the port of examples/gbp_pose_graph.py).

Solves a loop-closed odometry chain by synchronous message passing (every
factor-to-variable message of a sweep in one batched step), compares the
solution with Gauss-Newton's, and reads out each pose's posterior
marginal: the translation standard deviation grows away from the anchored
prior. Runs on the card unless --device cpu is given.

    python examples_torch/gbp_pose_graph.py [--n-poses 10] [--msg-iters 40] [--device cpu]
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
from theseus_tpu_torch.lie import se2


def build_graph(n, batch, seed, loop_closures, dtype=torch.float32, device=None):
    """The objective: noisy poses from the JAX script's numpy generator, a
    prior on x0 (weight 100), exact odometry and loop-closure measurements."""
    rng = np.random.default_rng(seed)
    gt_t, cur = [], np.zeros((batch, 3))
    for _ in range(n):
        gt_t.append(cur.copy())
        cur = cur + rng.normal(scale=0.5, size=(batch, 3)) * [1, 1, 0.5]
    gt = [se2.exp(torch.as_tensor(t)) for t in gt_t]
    obj = tt.Objective(dtype=dtype, device=device)
    poses = [tt.SE2(tensor=se2.exp(torch.as_tensor(gt_t[i] + rng.normal(scale=0.2, size=(batch, 3)))), name=f"x{i}")
             for i in range(n)]
    obj.add(tt.Difference(poses[0], tt.SE2(tensor=gt[0], name="prior_t"), tt.ScaleCostWeight(100.0), name="prior"))
    for i, j in [(i, i + 1) for i in range(n - 1)] + list(loop_closures):
        meas = se2.compose(se2.inverse(gt[i]), gt[j])
        obj.add(tt.Between(poses[i], poses[j], tt.SE2(tensor=meas, name=f"m{i}_{j}"), tt.ScaleCostWeight(1.0),
                           name=f"e{i}_{j}"))
    return obj


def run(n=10, batch=2, seed=0, msg_iters=40, msg_damping=0.4, max_iterations=12, dtype=torch.float32,
        device=None, verbose=True):
    """GBP and GN on the graph: {gbp_err, gn_err (B,), gap, stds (batch
    element 0's translation std per pose), values (GBP's solution)}."""
    obj = build_graph(n, batch, seed, [(0, n - 1), (1, n // 2)], dtype, device)
    gbp = tt.GaussianBeliefPropagation(obj, max_iterations=max_iterations, msg_iters=msg_iters,
                                       msg_damping=msg_damping)
    out, info = gbp.optimize()
    out_gn, info_gn = tt.GaussNewton(obj, max_iterations=max_iterations).optimize()
    gap = max(float((out[f"x{i}"] - out_gn[f"x{i}"]).abs().max()) for i in range(n))
    margs = gbp.marginals(values=out)
    stds = []
    for i in range(n):
        cov = np.linalg.inv(margs[f"x{i}"].precision[0].detach().cpu().double().numpy())
        stds.append(float(np.sqrt(cov[1, 1] + cov[2, 2])))
    if verbose:
        print(f"GBP   final err: {info.last_err.cpu().numpy()}")
        print(f"GN    final err: {info_gn.last_err.cpu().numpy()}")
        print(f"max |GBP - GN| over poses: {gap:.2e}")
        print("translation std per pose:", " ".join(f"{s:.3f}" for s in stds))
    return {"gbp_err": info.last_err, "gn_err": info_gn.last_err, "gap": gap, "stds": stds, "values": out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-poses", type=int, default=10)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--msg-iters", type=int, default=40)
    p.add_argument("--msg-damping", type=float, default=0.4)
    p.add_argument("--max-iterations", type=int, default=12)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    n = a.n_poses
    r = run(n, a.batch, a.seed, a.msg_iters, a.msg_damping, a.max_iterations, device=config.resolve_device(a.device))
    assert r["gap"] < 1e-4, "GBP should reach the GN fixed point on this graph"
    # the anchored pose is the most certain one
    assert r["stds"][0] < r["stds"][n // 2], "anchored pose should be most certain"
    print("done")


if __name__ == "__main__":
    main()
