#!/usr/bin/env python3
"""The implicit and DLM gradients of the PGO backward-mode sweep in theseus_tpu_torch and in the JAX package, against central differences, at one size, on the CPU in float64.

evaluations/backward_modes_sweep.py's `build` and `make_outer_loss` (the
JAX script, loaded by path) and evaluations_torch/backward_modes_sweep.py
on the same arrays (the JAX package's synthetic_pose_graph, seed 0), 10
GN iterations, theta = 0.3, h = 1e-4: whether a DLM gradient far from FD
is the port's or the method's. Imports both packages, like the CPU tests.

    JAX_PLATFORMS=cpu python3 scripts/dlm_scale_check.py [--n-poses 64] [--batch 8]
"""

import argparse
import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from evaluations_torch import backward_modes_sweep as bms  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-poses", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    a = p.parse_args(argv)
    from theseus_tpu.utils.examples.pose_graph import synthetic_pose_graph

    spec = importlib.util.spec_from_file_location("jax_backward_modes_sweep", ROOT / "evaluations" / "backward_modes_sweep.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    n, b, iters = a.n_poses, a.batch, 10
    jparts = jmod.build(n, b, iters, dtype=jnp.float64)
    gt, edges, meas, init = synthetic_pose_graph(n_poses=n, batch=b, seed=0, dtype=jnp.float64)
    t = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
    parts = bms.build(n, b, iters, torch.float64, "cpu", graph=(t(gt), edges, t(meas), t(init)))
    fd = float(bms.fd_gradient(parts, bms.THETA, 1e-4, torch.float64, "cpu"))
    for mode in ("implicit", "dlm"):
        jg = float(jax.jit(jax.grad(jmod.make_outer_loss(*jparts, mode, 4)))(jnp.asarray(bms.THETA)))
        g = float(bms.gradient(bms.make_outer_loss(*parts, mode, 4), bms.THETA, torch.float64, "cpu"))
        print(f"{n}x{b} {mode}: FD {fd:+.10f} port {g:+.10f} jax {jg:+.10f} port vs jax {abs(g - jg) / abs(jg):.2e} "
              f"port vs FD {abs(g - fd) / abs(fd):.2e}", flush=True)


if __name__ == "__main__":
    main()
