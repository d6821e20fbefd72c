"""`NLSOptions.damping_eps` in theseus_tpu_torch against the JAX package, on the CPU, in float64.

The JAX package never reads the option: its dense, sparse and Schur
builders keep their own eps of 1e-8. The port does the same. PGO 8 x 4
(seed 3) on the dense and sparse linearizations and a small bundle
adjustment on the Schur one, LM for 5 iterations with ellipsoidal damping
1e-2 and `damping_eps=1e-1`: final errors equal the JAX package's to
1e-10, and equal the port's own at the default eps exactly. A dense user
who wants another eps passes `linear_solver=DenseCholeskySolver(damping_eps=...)`,
as in the JAX package, and that one does move the solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils.examples.bundle_adjustment import (
    ba_values as jba_values,
    build_ba_objective as jbuild_ba,
    synthetic_ba as jsynthetic_ba,
)
from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild_pgo
import theseus_tpu_torch as tt
from theseus_tpu_torch.utils.convert import ba_problem_from_arrays
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

OPTS = dict(max_iterations=5, damping=1e-2, ellipsoidal_damping=True)


def _pgo(dtype_jax=False):
    gt, edges, meas, init = synthetic_pose_graph(8, 4, seed=3, dtype=torch.float64, device="cpu")
    if dtype_jax:
        jobj, _ = jbuild_pgo(8, edges, jnp.asarray(meas.numpy()), jnp.asarray(gt[0].numpy()), dtype=jnp.float64)
        return jobj, {f"pose_{i}": jnp.asarray(init[i].numpy()) for i in range(8)}
    obj, _ = build_pgo_objective(8, edges, meas, gt[0], dtype=torch.float64, device="cpu")
    return obj, pose_values(init)


def _ba(jax_side=False):
    jp = jsynthetic_ba(num_cameras=5, num_points=24, batch=2, seed=0, visibility=0.6, dtype=jnp.float64)
    if jax_side:
        jobj, _, _ = jbuild_ba(jp, gauge_target=jp.gt_poses[0])
        return jobj, jba_values(jp)
    keys = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img", "gt_poses", "gt_points")
    prob = ba_problem_from_arrays({k: np.asarray(getattr(jp, k)) for k in keys}, dtype=torch.float64, device="cpu")
    obj, _, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0])
    return obj, ba_values(prob)


def _port_err(linearization, **kw):
    obj, values = _ba() if linearization == "schur" else _pgo()
    opt = tt.LevenbergMarquardt(obj, linearization=linearization, **OPTS, **kw)
    return tt.TheseusLayer(opt).forward(values)[1].last_err.numpy()


@pytest.mark.parametrize("linearization", ["dense", "sparse", "schur"])
def test_damping_eps_is_read_by_no_builder(linearization):
    obj, values = _ba(jax_side=True) if linearization == "schur" else _pgo(dtype_jax=True)
    jopt = jt.LevenbergMarquardt(obj, linearization=linearization, damping_eps=1e-1, **OPTS)
    want = np.asarray(jt.TheseusLayer(jopt).forward(values)[1].last_err)
    got = _port_err(linearization, damping_eps=1e-1)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(got, _port_err(linearization))


def test_dense_solver_eps_moves_the_solve():
    default = _port_err("dense")
    moved = _port_err("dense", linear_solver=tt.DenseCholeskySolver(damping_eps=1e-1))
    assert np.all(np.abs(moved - default) > 1e-6 * default)
