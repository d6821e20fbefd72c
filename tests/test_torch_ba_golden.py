"""The JAX float64 bundle-adjustment golden that chip_smoke.py holds the port to on the card.

`tests/fixtures/ba_16x200_jax_f64.npz` holds the JAX package's synthetic BA
problem at 16 cameras x 200 points, visibility 0.4, batch 4, seed 0 (the
fields of its `BAProblem`, float64), and the per-batch final errors of its
float64 Levenberg-Marquardt solve: `linearization="schur"`, adaptive and
ellipsoidal damping, 30 iterations (every element converges). The test
recomputes both with `theseus_tpu` and checks that the committed file is
current, then checks that the port's float64 solve on the CPU reaches the
same plateau.

Regenerate the fixture after a deliberate change with

    python tests/test_torch_ba_golden.py --write
"""

import os
import sys
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "ba_16x200_jax_f64.npz"
CAMERAS, POINTS, BATCH, VISIBILITY, N_ITERS = 16, 200, 4, 0.4, 30
KEYS = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img")
# float64 plateau agreement of two implementations of the same algorithm:
# rounding order only (measured 5e-12 on the CPU)
PLATEAU_RTOL = 1e-9


def compute_golden():
    """(problem arrays, final errors) from the JAX package, in float64."""
    import jax
    import jax.numpy as jnp

    import theseus_tpu as tt
    from theseus_tpu.utils.examples.bundle_adjustment import (
        ba_values,
        build_ba_objective,
        synthetic_ba,
    )

    assert jax.config.jax_enable_x64, "the golden is a float64 solve"
    prob = synthetic_ba(num_cameras=CAMERAS, num_points=POINTS, batch=BATCH, seed=0,
                        visibility=VISIBILITY, dtype=jnp.float64)
    obj, _, _ = build_ba_objective(prob, dtype=jnp.float64)
    opt = tt.LevenbergMarquardt(obj, max_iterations=N_ITERS, adaptive_damping=True,
                                ellipsoidal_damping=True, linearization="schur")
    _, info = tt.TheseusLayer(opt).forward(ba_values(prob))
    arrays = {k: np.asarray(getattr(prob, k)) for k in KEYS}
    return arrays, np.asarray(info.last_err), np.asarray(info.status)


def test_golden_fixture_is_current():
    arrays, final_err, status = compute_golden()
    assert (status == 1).all()
    with np.load(FIXTURE) as f:
        for k in KEYS:
            np.testing.assert_array_equal(f[k], arrays[k], err_msg=k)
        assert int(f["n_iters"]) == N_ITERS
        np.testing.assert_allclose(f["final_err"], final_err, rtol=PLATEAU_RTOL)


def test_port_reaches_golden_plateau_on_cpu():
    import torch

    import theseus_tpu_torch as ttt
    from theseus_tpu_torch.utils.convert import load_ba_npz
    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective

    prob = load_ba_npz(FIXTURE, dtype=torch.float64, device="cpu")
    obj, _, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu")
    opt = ttt.LevenbergMarquardt(obj, max_iterations=N_ITERS, adaptive_damping=True,
                                 ellipsoidal_damping=True, linearization="schur")
    _, info = ttt.TheseusLayer(opt).forward(ba_values(prob))
    with np.load(FIXTURE) as f:
        np.testing.assert_allclose(info.last_err.numpy(), f["final_err"], rtol=PLATEAU_RTOL)
    assert (info.status.numpy() == 1).all()


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_ba_golden.py --write")
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_enable_x64", True)
    arrays, final_err, _ = compute_golden()
    np.savez_compressed(FIXTURE, final_err=final_err, n_iters=N_ITERS, **arrays)
    print("wrote", FIXTURE, "mean final err", float(final_err.mean()))
