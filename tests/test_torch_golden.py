"""The JAX float64 golden that chip_smoke.py holds the port to on the card.

`tests/fixtures/pgo_64x16_jax_f64.npz` holds the 64-pose x batch-16 PGO
problem (seed 0, the arrays scripts/dump_problem_npz.py writes, in float64)
and the JAX package's per-batch final errors after a converged float64
Levenberg-Marquardt solve (adaptive damping, 30 iterations; the solve
converges in 5-7). The test recomputes both with `theseus_tpu` and checks
that the committed file is current, then checks that the port's float64
solve on the CPU reaches the same plateau.

Regenerate the fixture after a deliberate change with

    python tests/test_torch_golden.py --write

The JAX reference uses the dense linearization: on this problem its float64
errors agree with the sparse path's to ~1e-14, and it compiles in a quarter
of the time.
"""

import os
import sys
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "pgo_64x16_jax_f64.npz"
N_POSES, BATCH, N_ITERS, PRIOR_WEIGHT = 64, 16, 30, 10.0
# float64 plateau agreement between two implementations of the same
# algorithm: rounding-order differences only, amplified by the LM solve
PLATEAU_RTOL = 1e-9


def compute_golden():
    """(problem arrays, final errors) from the JAX package, in float64."""
    import jax
    import jax.numpy as jnp

    import theseus_tpu as tt
    from theseus_tpu.utils.examples.pose_graph import (
        build_pgo_objective,
        pose_values,
        synthetic_pose_graph,
    )

    assert jax.config.jax_enable_x64, "the golden is a float64 solve"
    gt, edges, meas, init = synthetic_pose_graph(
        n_poses=N_POSES, batch=BATCH, seed=0, dtype=jnp.float64
    )
    obj, _ = build_pgo_objective(N_POSES, edges, meas, gt[0], dtype=jnp.float64,
                                 prior_weight=PRIOR_WEIGHT)
    opt = tt.LevenbergMarquardt(obj, max_iterations=N_ITERS, adaptive_damping=True,
                                linearization="dense")
    _, info = tt.TheseusLayer(opt).forward(pose_values(init))
    arrays = dict(
        problem="pgo",
        n_poses=N_POSES,
        batch=BATCH,
        gt=np.asarray(gt),
        edges=np.asarray(edges, np.int64),
        measurements=np.asarray(meas),
        init=np.asarray(init),
        prior_weight=PRIOR_WEIGHT,
    )
    return arrays, np.asarray(info.last_err)


def test_golden_fixture_is_current():
    arrays, final_err = compute_golden()
    with np.load(FIXTURE) as f:
        for k in ("gt", "edges", "measurements", "init"):
            np.testing.assert_array_equal(f[k], arrays[k], err_msg=k)
        assert float(f["prior_weight"]) == PRIOR_WEIGHT
        assert int(f["n_iters"]) == N_ITERS
        np.testing.assert_allclose(f["final_err"], final_err, rtol=PLATEAU_RTOL)


def test_port_reaches_golden_plateau_on_cpu():
    import torch

    import theseus_tpu_torch as ttt
    from theseus_tpu_torch.utils.convert import load_problem_npz

    obj, inputs = load_problem_npz(FIXTURE, dtype=torch.float64)
    opt = ttt.LevenbergMarquardt(obj, max_iterations=N_ITERS, adaptive_damping=True)
    _, info = ttt.TheseusLayer(opt).forward(inputs)
    with np.load(FIXTURE) as f:
        np.testing.assert_allclose(info.last_err.numpy(), f["final_err"], rtol=PLATEAU_RTOL)
    assert (info.status.numpy() == 1).all()


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_golden.py --write")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)
    arrays, final_err = compute_golden()
    np.savez_compressed(FIXTURE, final_err=final_err, n_iters=N_ITERS, **arrays)
    print("wrote", FIXTURE, "mean final err", float(final_err.mean()))
