#!/usr/bin/env python3
"""Write the JAX float64 golden of the 2-D pose-graph path: tests/fixtures/pgo2d_<n>_jax_f64.npz.

The graph is scripts/manhattan_g2o.py's at `--poses` poses (500 by
default) and `--seed` (0), written to a temporary g2o file and read back
with the JAX package's `read_2d_g2o`. The objective is an SE2 variable per
pose, a Between per edge with a DiagonalCostWeight of the uniform
sqrt-information, and a Local prior on pose 0 with weight 10 (as
`build_pgo_objective`). LevenbergMarquardt with adaptive damping on the
sparse linearization, 30 iterations, on the CPU in float64. The file holds
the final poses (N, 4), the per-iteration error and the settings; the CPU
test tests/test_torch_g2o_2d.py and chip_smoke.py's `pgo2d` phase hold the
port to it (1e-8), regenerating the graph from the seed.

    JAX_PLATFORMS=cpu python3 scripts/make_pgo2d_golden.py [--poses 500] [--seed 0]

This script imports jax and the JAX package; the port does not import it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ITERS = 30
PRIOR_WEIGHT = 10.0


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--poses", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import theseus_tpu as jt
    from manhattan_g2o import generate, write_g2o
    from theseus_tpu.utils.examples.pose_graph import read_2d_g2o

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.g2o")
        write_g2o(path, generate(a.poses, a.seed))
        n, poses, edges, meas, w = read_2d_g2o(path, dtype=jnp.float64)
    sqrt_info = np.sqrt(np.diag(np.asarray(w[0]).T @ np.asarray(w[0])))[None]
    obj = jt.Objective(dtype=jnp.float64)
    xs = [jt.SE2(name=f"pose_{i}") for i in range(n)]
    obj.add(jt.Local(xs[0], np.asarray(poses[0]), jt.ScaleCostWeight(PRIOR_WEIGHT), name="prior"))
    weight = jt.DiagonalCostWeight(sqrt_info)
    meas = np.asarray(meas)
    for e, (i, j) in enumerate(edges):
        obj.add(jt.Between(xs[i], xs[j], meas[e], cost_weight=weight, name=f"edge_{e}"))
    opt = jt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True, linearization="sparse")
    t0 = time.perf_counter()
    out, info = jt.TheseusLayer(opt).forward({f"pose_{i}": poses[i] for i in range(n)})
    seconds = time.perf_counter() - t0
    final = np.stack([np.asarray(out[f"pose_{i}"])[0] for i in range(n)])
    hist = np.asarray(info.err_history)[:, 0]
    dest = ROOT / "tests" / "fixtures" / f"pgo2d_{a.poses}_jax_f64.npz"
    np.savez_compressed(dest, poses=final, err_history=hist, last_err=np.asarray(info.last_err),
                        n_poses=a.poses, n_edges=len(edges), seed=a.seed, iters=ITERS, prior_weight=PRIOR_WEIGHT)
    print(f"{dest.relative_to(ROOT)}: {n} poses, {len(edges)} edges, error {hist[0]:.6e} -> "
          f"{float(info.last_err[0]):.12e} in {ITERS} LM iterations ({seconds:.1f} s on the CPU, compile included)")


if __name__ == "__main__":
    main()
