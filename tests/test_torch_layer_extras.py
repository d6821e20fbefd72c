"""The layer's extras of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `compute_covariances`: the SE2 chain with a loop closure of
  tests/core/test_covariances.py, solved by Gauss-Newton, on the sparse
  path (the block factor and unit-column solves) and the dense path (one
  inverse), against the JAX package's on the same values: 1e-10; a subset
  of variables; the Schur path; a Gaussian-belief-propagation optimizer's
  belief covariances against the JAX package's (1e-8), every variable and
  one variable under damping.
- `sample_with_factor`: the same standard-normal y through both packages'
  backward sweeps on the same factor layout (the same natural ordering):
  1e-10.
- `compute_samples`: the empirical covariance and mean of 4000 samples
  (the JAX package's test_compute_samples_sparse_matches_dense_cov case),
  on the sparse and the dense path.
- `verify_jacobians`: true on the motion planner's objective, false on a
  cost whose analytic jacobian is wrong.
- `MovingFrameBetween` (SE2 and SE3): the dense weighted jacobian, b and
  the error metric against JAX's, 1e-10 relative to max(1, |A|).
- `IdentityModel` and `UrdfRobotModel` (the 7-dof arm): link poses and body
  jacobians against JAX's, 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.embodied.kinematics import IdentityModel as JIdentityModel
from theseus_tpu.embodied.kinematics import UrdfRobotModel as JUrdfRobotModel
from theseus_tpu.optim.normal import SparseNormalBuilder as JSparseNormalBuilder
from theseus_tpu.sparse.cholesky import factorize as jfactorize
from theseus_tpu.sparse.cholesky import sample_with_factor as jsample_with_factor
import theseus_tpu_torch as tt
from theseus_tpu_torch.lie import se2, se3
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse.cholesky import factorize, sample_with_factor
from theseus_tpu_torch.utils.examples.inverse_kinematics import ARM_7DOF
from theseus_tpu_torch.utils.examples.motion_planning import MotionPlanner

TOL = 1e-10


def _chain(m, n=5, batch=2, seed=0):
    """The SE2 chain of tests/core/test_covariances.py in either package."""
    rng = np.random.default_rng(seed)
    gt_t, cur = [], np.zeros((batch, 3))
    for _ in range(n):
        gt_t.append(cur.copy())
        cur = cur + rng.normal(scale=0.4, size=(batch, 3))
    gt = [se2.exp(torch.as_tensor(t)).numpy() for t in gt_t]
    obj = m.Objective(dtype=jnp.float64) if m is jt else m.Objective(dtype=torch.float64, device="cpu")
    poses = [m.SE2(tensor=se2.exp(torch.as_tensor(gt_t[i] + rng.normal(scale=0.1, size=(batch, 3)))).numpy(),
                   name=f"x{i}") for i in range(n)]
    obj.add(m.Difference(poses[0], m.SE2(tensor=gt[0], name="pt"), m.ScaleCostWeight(10.0), name="prior"))
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        meas = se2.compose(se2.inverse(torch.as_tensor(gt[i])), torch.as_tensor(gt[j])).numpy()
        obj.add(m.Between(poses[i], poses[j], m.SE2(tensor=meas, name=f"m{i}_{j}"), m.ScaleCostWeight(1.0),
                          name=f"e{i}_{j}"))
    return obj


def _values(out, names):
    return {n: np.asarray(out[n]) for n in names}


@pytest.mark.parametrize("linearization", ["dense", "sparse"])
@pytest.mark.parametrize("damping", [0.0, 1e-6])
def test_covariances_match_jax(linearization, damping):
    jobj = _chain(jt)
    jopt = jt.GaussNewton(jobj, max_iterations=8, linearization=linearization)
    jout, _ = jopt.optimize()
    names = [f"x{i}" for i in range(5)]
    vals = _values(jout, names)
    want = jt.TheseusLayer(jopt).compute_covariances(values=dict(jobj.default_values(), **jout), damping=damping)
    obj = _chain(tt)
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=8, linearization=linearization))
    got = layer.compute_covariances(values=obj.default_values(vals), damping=damping)
    assert set(got) == set(names)
    for n in names:
        assert tuple(got[n].shape) == (2, 3, 3)
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=TOL, atol=TOL)
    sub = layer.compute_covariances(values=obj.default_values(vals), var_names=["x2"], damping=damping)
    assert set(sub) == {"x2"}
    np.testing.assert_allclose(sub["x2"].numpy(), got["x2"].numpy(), rtol=TOL, atol=TOL)


def test_covariances_schur_path_and_gbp_error():
    obj = _chain(tt)
    out, _ = tt.GaussNewton(obj, max_iterations=8).optimize()
    dense = tt.TheseusLayer(tt.GaussNewton(obj, linearization="dense")).compute_covariances(values=out)
    schur = tt.TheseusLayer(tt.GaussNewton(obj, linearization="schur", eliminate=lambda n, g: n in ("x2", "x4")))
    for n, c in schur.compute_covariances(values=out).items():
        np.testing.assert_allclose(c.numpy(), dense[n].numpy(), rtol=TOL, atol=TOL)

    # GBP: each variable's belief precision inverted, against the JAX
    # package's on the same values (the loopy chain: GBP's beliefs are not
    # the exact marginals there, and both packages give the same ones)
    jobj = _chain(jt)
    kw = dict(max_iterations=8, msg_iters=20, msg_damping=0.2)
    jgbp = jt.GaussianBeliefPropagation(jobj, **kw)
    jout, _ = jgbp.optimize()
    names = [f"x{i}" for i in range(5)]
    vals = _values(jout, names)
    want = jt.TheseusLayer(jgbp).compute_covariances(values=dict(jobj.default_values(), **jout))
    layer = tt.TheseusLayer(tt.GaussianBeliefPropagation(obj, **kw))
    got = layer.compute_covariances(values=obj.default_values(vals))
    assert set(got) == set(names)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=1e-8, atol=1e-10)
    sub = layer.compute_covariances(values=obj.default_values(vals), var_names=["x3"], damping=1e-3)
    jsub = jt.TheseusLayer(jgbp).compute_covariances(values=dict(jobj.default_values(), **jout), var_names=["x3"],
                                                     damping=1e-3)
    np.testing.assert_allclose(sub["x3"].numpy(), np.asarray(jsub["x3"]), rtol=1e-8, atol=1e-10)


def test_sample_with_factor_matches_jax():
    jobj, obj = _chain(jt), _chain(tt)
    names = [f"x{i}" for i in range(5)]
    jco, co = jobj.compile(), obj.compile()
    jvals, vals = jobj.default_values(), obj.default_values()
    jbld = JSparseNormalBuilder(jco, ordering=names)
    bld = SparseNormalBuilder(co, ordering=names)
    jns = jbld.build(jco.pack(jvals, 2), jco.build_aux(jvals, 2))
    ns = bld.build(co.pack(vals, 2), co.build_aux(vals, 2))
    np.testing.assert_allclose(ns.ata.numpy(), np.asarray(jns.ata), rtol=1e-12, atol=1e-12)
    jl, factor = jfactorize(jbld.sched, jns.ata), factorize(bld.sched, ns.ata)
    assert factor.tail is None
    np.testing.assert_allclose(factor.blocks.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    y = np.random.default_rng(5).standard_normal((5, 2, 3))
    want = np.asarray(jsample_with_factor(jbld.sched, jl, jnp.asarray(y)))
    got = sample_with_factor(bld.sched, factor, torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _linear_chain(batch=2, dim=3):
    """Two vector variables with a prior and a difference cost (the JAX
    package's _chain_objective): AtA = [[2I, -I], [-I, I]]."""
    rng = np.random.RandomState(4)
    t0, d01 = rng.randn(batch, dim), rng.randn(batch, dim)
    x0, x1 = tt.Vector(dim, name="x0"), tt.Vector(dim, name="x1")
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(tt.AutoDiffCostFunction([x0], dim, lambda o, a: o[0] - a[0],
                                    aux_vars=[tt.Variable(t0, name="t0")], name="prior"))
    obj.add(tt.AutoDiffCostFunction([x0, x1], dim, lambda o, a: o[1] - o[0] - a[0],
                                    aux_vars=[tt.Variable(d01, name="d01")], name="between"))
    return obj, t0, d01


@pytest.mark.parametrize("linearization", ["sparse", "dense"])
def test_compute_samples_match_the_posterior(linearization):
    obj, t0, d01 = _linear_chain()
    dim, batch = 3, 2
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=5, linearization=linearization))
    z = torch.zeros((batch, dim), dtype=torch.float64)
    values, _ = layer.forward({"x0": z, "x1": z})
    n_s = 4000
    samples = layer.compute_samples(values=values, n_samples=n_s, generator=torch.Generator().manual_seed(11))
    assert tuple(samples["x0"].shape) == (batch, n_s, dim)
    s = np.concatenate([samples["x0"].numpy(), samples["x1"].numpy()], axis=-1)  # (B, S, 2 dim)
    ata = np.block([[2 * np.eye(dim), -np.eye(dim)], [-np.eye(dim), np.eye(dim)]])
    cov_true = np.linalg.inv(ata)
    for b in range(batch):
        np.testing.assert_allclose(np.cov(s[b].T), cov_true, atol=0.15)
        np.testing.assert_allclose(s[b].mean(axis=0), np.concatenate([t0[b], t0[b] + d01[b]]), atol=0.1)
    # temperature scales the covariance
    cold = layer.compute_samples(values=values, n_samples=n_s, temperature=0.25,
                                 generator=torch.Generator().manual_seed(11))
    np.testing.assert_allclose(np.cov(cold["x0"].numpy()[0].T), 0.25 * cov_true[:dim, :dim], atol=0.05)


def test_verify_jacobians(capsys):
    planner = MotionPlanner(8, 0.4, 2.0, 20.0, np.eye(2), 4, device="cpu")
    assert planner.layer.verify_jacobians()

    class WrongLocal(tt.Local):
        def jacobians_impl(self, optim, aux):
            jacs, err = super().jacobians_impl(optim, aux)
            return [2.0 * j for j in jacs], err

    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(tt.Local(tt.SE2(name="a"), se2.exp(torch.zeros(1, 3)).numpy(), name="good"))
    obj.add(WrongLocal(tt.SE2(name="b"), se2.exp(torch.zeros(1, 3)).numpy(), name="bad"))
    assert not tt.TheseusLayer(tt.GaussNewton(obj)).verify_jacobians()
    out = capsys.readouterr().out
    assert "Jacobian check failed for bad" in out and "good" not in out


@pytest.mark.parametrize("group", ["SE2", "SE3"])
def test_moving_frame_between_matches_jax(group):
    rng = np.random.default_rng({"SE2": 0, "SE3": 1}[group])
    k, batch = 4, 3
    mod, dof = (se2, 3) if group == "SE2" else (se3, 6)
    el = lambda *shape: mod.exp(torch.as_tensor(0.7 * rng.standard_normal(shape + (dof,)))).numpy()  # noqa: E731
    arrays = {f"{v}{i}": el(batch) for v in ("f1_", "f2_", "p1_", "p2_") for i in range(k)}
    meas = el(k, batch)
    out = {}
    for m in (jt, tt):
        obj = m.Objective(dtype=jnp.float64) if m is jt else m.Objective(dtype=torch.float64, device="cpu")
        var = getattr(m, group)
        for i in range(k):
            obj.add(m.MovingFrameBetween(var(name=f"f1_{i}"), var(name=f"f2_{i}"), var(name=f"p1_{i}"),
                                         var(name=f"p2_{i}"), meas[i], m.ScaleCostWeight(2.0), name=f"mf{i}"))
        co = obj.compile()
        vals = obj.default_values({n: (jnp.asarray(a) if m is jt else a) for n, a in arrays.items()})
        if m is jt:
            vals = {n: jnp.asarray(v) for n, v in vals.items()}
        state, aux = co.pack(vals, batch), co.build_aux(vals, batch)
        a, b = co.dense_A_b(state, aux)
        out[m.__name__] = [np.asarray(x) for x in (a, b, co.error_metric(state, aux))]
    for j, t in zip(out["theseus_tpu"], out["theseus_tpu_torch"]):
        assert np.abs(j - t).max() <= TOL * max(1.0, np.abs(j).max())


def test_kinematics_models_match_jax():
    rng = np.random.default_rng(2)
    pose = rng.standard_normal((4, 3))
    assert np.array_equal(tt.IdentityModel().forward_kinematics(torch.as_tensor(pose))["state"].numpy(),
                          np.asarray(JIdentityModel().forward_kinematics(jnp.asarray(pose))["state"]))
    jm = JUrdfRobotModel(urdf_string=ARM_7DOF)
    m = tt.UrdfRobotModel(urdf_string=ARM_7DOF)
    assert m.dof == jm.dof == 7 and m.link_names == jm.link_names
    with pytest.raises(ValueError):
        tt.UrdfRobotModel()
    q = rng.uniform(-1.5, 1.5, (5, 7))
    poses, jacs = m.fk_with_body_jacobians(torch.as_tensor(q))
    jposes, jjacs = jm.fk_with_body_jacobians(jnp.asarray(q))
    fk = m.forward_kinematics(torch.as_tensor(q))
    for name in m.link_names:
        np.testing.assert_allclose(poses[name].numpy(), np.asarray(jposes[name]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(fk[name].numpy(), np.asarray(jposes[name]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(jacs[name].numpy(), np.asarray(jjacs[name]), rtol=TOL, atol=TOL)
