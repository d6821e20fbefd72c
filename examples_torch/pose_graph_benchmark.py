"""g2o pose-graph timing harness (the port of examples/pose_graph_benchmark.py).

Loads a 3D g2o file (e.g. sphere2500) or, without one, generates a
synthetic problem of --n-poses, runs LM on the block-sparse Cholesky (the
level kernels on the card) and reports the per-iteration time and the
chi2 history. The second, timed run starts from a state scaled by
1 + 1e-7, as the JAX script's. Runs on the card unless --device cpu is
given.

    python examples_torch/pose_graph_benchmark.py [--g2o FILE] [--n-poses 256] [--iters 10] [--f32] [--device cpu]
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
from theseus_tpu_torch.utils.examples.pose_graph import (build_pgo_objective, pose_values, read_3d_g2o,
                                                         synthetic_pose_graph)
from theseus_tpu_torch.utils.timer import device_sync


def run(g2o_path=None, n_poses=256, iters=10, dtype=torch.float64, device=None):
    """(chi2 history (iters + 1, B), seconds of the first run, of the timed run)."""
    dev = config.resolve_device(device)
    if g2o_path:
        n, poses, edges, meas, _ = read_3d_g2o(g2o_path, dtype, dev)
        obj, _ = build_pgo_objective(n, edges, meas, poses[0], dtype=dtype, device=dev)
        init = {f"pose_{i}": poses[i] for i in range(n)}
        batch = 1
    else:
        gt, edges, meas, init_poses = synthetic_pose_graph(n_poses, 1, dtype=dtype, device=dev)
        obj, _ = build_pgo_objective(n_poses, edges, meas, gt[0], dtype=dtype, device=dev)
        init = pose_values(init_poses)
        n, batch = n_poses, 1
    opt = tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization="sparse")
    co = obj.compile()
    values = obj.default_values(init)
    state = co.pack(values, batch)
    aux = co.build_aux(values, batch)

    def solve(state):
        with torch.no_grad():
            carry = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, iters, opt.opts)
        device_sync(dev)
        return carry["history"]

    t0 = time.perf_counter()
    solve(state)
    first = time.perf_counter() - t0
    state2 = {k: v * (1.0 + 1e-7) for k, v in state.items()}
    t0 = time.perf_counter()
    hist = solve(state2)
    steady = time.perf_counter() - t0
    print(f"n_poses={n} edges={len(obj.cost_functions) - 1} iters={iters}")
    print(f"first call (incl. symbolic analysis and kernel builds): {first:.2f}s; steady: {steady * 1e3:.1f} ms "
          f"({steady / iters * 1e3:.2f} ms/iter)")
    print("chi2 history:", hist[:, 0].cpu().numpy())
    return hist, first, steady


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--g2o", default=None)
    p.add_argument("--n-poses", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--f32", action="store_true", help="float32 (default: float64)")
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    run(a.g2o, a.n_poses, a.iters, torch.float32 if a.f32 else torch.float64, a.device)


if __name__ == "__main__":
    main()
