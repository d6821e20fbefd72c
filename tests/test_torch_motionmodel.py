"""The motion-model costs of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The same objective is built in both packages from the same numpy arrays
(a seed per case, K instances at batch B): its dense weighted jacobian A,
b = -err and the error metric must agree to 1e-12 relative to
max(1, max |A|) (the same closed forms; libm against XLA differ by an ulp).
Cases: DoubleIntegrator over Point2 / Vector(2) and over SE2 / Vector(3);
GPMotionModel (the GP weight's upper factor U applied to error and
jacobians); HingeCost with values below, inside and above its limits;
Nonholonomic with an SE2 and a 3-vector pose; QuasiStaticPushingPlanar
(autodiff jacobians in both packages) at zero motion and at random states.
GPCostWeight's factor itself (U^T U = W) against the JAX package's, 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.embodied.motionmodel import GPCostWeight as JGPCostWeight
import theseus_tpu_torch as tt
from theseus_tpu_torch.lie import se2

K, B = 4, 3
TOL = 1e-12


def _se2(rng, shape, scale=1.0):
    return se2.exp(torch.as_tensor(scale * rng.standard_normal(shape + (3,)))).numpy()


def _compare(build, inputs):
    """A, b and the error metric of the objective `build(pkg)` in both
    packages at `inputs`."""
    out = {}
    for pkg in ("jax", "torch"):
        obj = build(pkg)
        co = obj.compile()
        values = obj.default_values({k: v for k, v in inputs.items()})
        if pkg == "jax":
            values = {k: jnp.asarray(v) for k, v in values.items()}
        bsz = co.resolve_batch_size(values)
        state, aux = co.pack(values, bsz), co.build_aux(values, bsz)
        a, b = co.dense_A_b(state, aux)
        out[pkg] = [np.asarray(x) for x in (a, b, co.error_metric(state, aux))]
    for name, j, t in zip(("A", "b", "error"), out["jax"], out["torch"]):
        assert j.shape == t.shape, name
        scale = max(1.0, float(np.abs(j).max()))
        assert np.abs(j - t).max() <= TOL * scale, (name, np.abs(j - t).max(), scale)
    return out["torch"]


def _objective(pkg):
    if pkg == "jax":
        return jt, jt.Objective(dtype=jnp.float64)
    return tt, tt.Objective(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("space", ["point2", "se2"])
@pytest.mark.parametrize("weighting", ["scale", "gp"])
def test_double_integrator_and_gp(space, weighting):
    rng = np.random.default_rng({"point2": 0, "se2": 1}[space] + {"scale": 0, "gp": 10}[weighting])
    dof = 2 if space == "point2" else 3
    dt = 0.1
    qc = np.array([[1.3, 0.2], [0.2, 0.7]]) if dof == 2 else np.diag([1.0, 2.0, 0.5])
    if space == "point2":
        poses = rng.standard_normal((K + 1, B, 2))
    else:
        poses = _se2(rng, (K + 1, B))
    vels = rng.standard_normal((K + 1, B, dof))

    def build(pkg):
        m, obj = _objective(pkg)
        ps = [m.Point2(name=f"p{i}") if space == "point2" else m.SE2(name=f"p{i}") for i in range(K + 1)]
        vs = [m.Vector(dof, name=f"v{i}") for i in range(K + 1)]
        for i in range(K):
            if weighting == "gp":
                w = m.GPCostWeight(qc, dt, name=f"w{i}")
                obj.add(m.GPMotionModel(ps[i], vs[i], ps[i + 1], vs[i + 1], dt, w, name=f"gp{i}"))
            else:
                obj.add(m.DoubleIntegrator(ps[i], vs[i], ps[i + 1], vs[i + 1], dt,
                                           m.ScaleCostWeight(2.5), name=f"di{i}"))
        return obj

    inputs = {f"p{i}": poses[i] for i in range(K + 1)}
    inputs.update({f"v{i}": vels[i] for i in range(K + 1)})
    a, _, _ = _compare(build, inputs)
    assert np.abs(a).max() > 1.0


@pytest.mark.parametrize("dt", [0.1, 0.5, np.array([0.2, 0.05, 1.0])])
def test_gp_cost_weight_factor(dt):
    rng = np.random.default_rng(3)
    m = rng.standard_normal((B, 2, 2))
    qc = m @ np.swapaxes(m, -1, -2) + 0.5 * np.eye(2)
    dt_col = np.reshape(np.asarray(dt, np.float64), (-1, 1)) * np.ones((B, 1))
    jw = JGPCostWeight(jnp.asarray(qc[0]), 0.1)
    want = np.stack([np.asarray(jw._weight_matrix(jnp.asarray(qc[b]), jnp.asarray(dt_col[b]))) for b in range(B)])
    got = tt.GPCostWeight.weight_factor(torch.as_tensor(qc), torch.as_tensor(dt_col)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())
    # U is upper triangular with U^T U = W
    assert np.allclose(np.tril(got, -1), 0.0)
    w = np.swapaxes(got, -1, -2) @ got
    d = dt_col[:, :, None]
    np.testing.assert_allclose(w[:, :2, :2], 12.0 / d ** 3 * qc, rtol=1e-10)
    np.testing.assert_allclose(w[:, :2, 2:], -6.0 / d ** 2 * qc, rtol=1e-10)
    # a weight that is not positive definite gives NaN (no host sync, no raise)
    bad = tt.GPCostWeight.weight_factor(torch.as_tensor(-qc), torch.as_tensor(dt_col))
    assert bool(torch.isnan(bad).all())


def test_hinge_cost():
    rng = np.random.default_rng(4)
    dof = 3
    down, up, thr = np.array([-1.0, -0.5, 0.0]), np.array([1.0, 0.5, 2.0]), 0.1
    vals = 1.5 * rng.standard_normal((K, B, dof))
    vals[0, 0] = [-0.9, 0.0, 1.0]  # inside every limit

    def build(pkg):
        m, obj = _objective(pkg)
        for i in range(K):
            obj.add(m.HingeCost(m.Vector(dof, name=f"x{i}"), down, up, thr, m.ScaleCostWeight(3.0), name=f"h{i}"))
        return obj

    a, b, _ = _compare(build, {f"x{i}": vals[i] for i in range(K)})
    assert (b == 0).any() and (b != 0).any()


@pytest.mark.parametrize("pose_kind", ["se2", "vector3"])
def test_nonholonomic(pose_kind):
    rng = np.random.default_rng(5)
    poses = _se2(rng, (K, B)) if pose_kind == "se2" else rng.standard_normal((K, B, 3))
    vels = rng.standard_normal((K, B, 3))

    def build(pkg):
        m, obj = _objective(pkg)
        for i in range(K):
            p = m.SE2(name=f"p{i}") if pose_kind == "se2" else m.Vector(3, name=f"p{i}")
            obj.add(m.Nonholonomic(p, m.Vector(3, name=f"v{i}"), m.ScaleCostWeight(1.5), name=f"n{i}"))
        return obj

    inputs = {f"p{i}": poses[i] for i in range(K)}
    inputs.update({f"v{i}": vels[i] for i in range(K)})
    _compare(build, inputs)


@pytest.mark.parametrize("motion", ["zero", "random"])
def test_quasi_static_pushing_planar(motion):
    rng = np.random.default_rng(6)
    obj1 = _se2(rng, (K, B))
    eff1 = _se2(rng, (K, B))
    if motion == "zero":
        obj2, eff2 = obj1.copy(), eff1.copy()
    else:
        obj2, eff2 = _se2(rng, (K, B), 0.3), _se2(rng, (K, B), 0.3)
    c_square = 0.09

    def build(pkg):
        m, obj = _objective(pkg)
        for i in range(K):
            obj.add(m.QuasiStaticPushingPlanar(m.SE2(name=f"o1_{i}"), m.SE2(name=f"o2_{i}"), m.SE2(name=f"e1_{i}"),
                                               m.SE2(name=f"e2_{i}"), c_square, name=f"push{i}"))
        return obj

    inputs = {}
    for i in range(K):
        inputs.update({f"o1_{i}": obj1[i], f"o2_{i}": obj2[i], f"e1_{i}": eff1[i], f"e2_{i}": eff2[i]})
    a, b, _ = _compare(build, inputs)
    if motion == "zero":  # no motion: V = Vp = 0
        assert np.abs(b).max() < 1e-12
