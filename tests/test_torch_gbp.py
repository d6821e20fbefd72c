"""Gaussian belief propagation and the manifold Gaussians of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The SE2 chains of tests/optim/test_gbp.py (a prior and odometry: a tree),
with two loop closures for the loopy case, built in both packages from the
same numpy seed:

- `GBPNormal.Atb`, `diag` and `quad` against JAX's on the same graph
  (1e-12 relative to max(1, |x|)) and against the dense system (1e-9);
- the GBP delta on a tree (12 sweeps, no message damping, ridge 1e-12)
  against JAX's (1e-10) and against dense Gauss-Newton's (rtol 1e-6, atol
  1e-8, the JAX test's);
- a loopy solve (15 outer iterations, 40 sweeps, damping 0.4): solution and
  error against JAX's (1e-8); within 5e-5 of Gauss-Newton (the JAX test's);
- `marginals()` on a tree against JAX's (1e-8) and against the inverse of
  the dense covariance's block (rtol 1e-4, the JAX test's);
- unroll, implicit, truncated and dlm gradients with respect to a tangent
  perturbation of a measurement, each against JAX's same mode: 1e-7
  relative to the largest entry;
- a cost that names one variable in two slots raises; a per-call
  `msg_iters` changes the schedule (the JAX test's case, and the error
  against JAX's run);
- `local_gaussian` and `retract_gaussian` for SE2, SE3 and SO3 against
  JAX's on the same elements and precision: 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.lie import se2 as jse2
from theseus_tpu.optim.gaussian import ManifoldGaussian as JManifoldGaussian
from theseus_tpu.optim.gaussian import local_gaussian as jlocal_gaussian
from theseus_tpu.optim.gaussian import retract_gaussian as jretract_gaussian
from theseus_tpu.optim.gbp import GBPNormalBuilder as JGBPNormalBuilder
from theseus_tpu.optim.normal import DenseNormalBuilder as JDenseNormalBuilder
import theseus_tpu_torch as tt
from theseus_tpu_torch.lie import group as tgroup
from theseus_tpu_torch.lie import se2
from theseus_tpu_torch.optim.gbp import GBPNormalBuilder
from theseus_tpu_torch.optim.normal import DenseNormalBuilder


def _chain(m, n=6, batch=2, seed=0, loops=()):
    """SE2 odometry chain, a prior on x0 and Between loop closures."""
    rng = np.random.default_rng(seed)
    gt_t, cur = [], np.zeros((batch, 3))
    for _ in range(n):
        gt_t.append(cur.copy())
        cur = cur + rng.normal(scale=0.4, size=(batch, 3))
    gt = [se2.exp(torch.as_tensor(t)) for t in gt_t]
    obj = jt.Objective(dtype=jnp.float64) if m is jt else tt.Objective(dtype=torch.float64, device="cpu")
    poses = [m.SE2(tensor=se2.exp(torch.as_tensor(gt_t[i] + rng.normal(scale=0.15, size=(batch, 3)))).numpy(),
                   name=f"x{i}") for i in range(n)]
    obj.add(m.Difference(poses[0], m.SE2(tensor=gt[0].numpy(), name="prior_t"), m.ScaleCostWeight(10.0),
                         name="prior"))
    for i, j in [(i, i + 1) for i in range(n - 1)] + list(loops):
        meas = se2.compose(se2.inverse(gt[i]), gt[j]).numpy()
        obj.add(m.Between(poses[i], poses[j], m.SE2(tensor=meas, name=f"m{i}_{j}"), m.ScaleCostWeight(1.0),
                          name=f"e{i}_{j}"))
    return obj, poses


def _loopy(m, n=8):
    return _chain(m, n, seed=3, loops=[(0, n - 1), (1, n // 2)])[0]


def _packed(obj):
    co = obj.compile()
    values = obj.default_values()
    b = co.resolve_batch_size(values)
    return co, co.pack(values, b), co.build_aux(values, b)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(1.0, float(np.max(np.abs(want)))))


def test_gbp_atb_diag_quad_match_jax_and_dense():
    (jco, js, ja), (co, s, a) = _packed(_chain(jt, n=4)[0]), _packed(_chain(tt, n=4)[0])
    jns = JGBPNormalBuilder(jco, msg_iters=8, ridge=1e-12).build(js, ja)
    ns = GBPNormalBuilder(co, msg_iters=8, ridge=1e-12).build(s, a)
    dense = DenseNormalBuilder(co).build(s, a)
    v = np.random.default_rng(0).normal(size=tuple(ns.Atb.shape))
    for got, want, ref in ((ns.Atb, jns.Atb, dense.Atb), (ns.diag(), jns.diag(), dense.diag()),
                           (ns.quad(torch.as_tensor(v)), jns.quad(jnp.asarray(v)), dense.quad(torch.as_tensor(v)))):
        _close(got.numpy(), want, 1e-12)
        _close(got.numpy(), ref.numpy(), 1e-9)


def test_gbp_delta_on_tree_matches_jax_and_dense_gn():
    (jco, js, ja), (co, s, a) = _packed(_chain(jt)[0]), _packed(_chain(tt)[0])
    jd, _ = JGBPNormalBuilder(jco, msg_iters=12, msg_damping=0.0, ridge=1e-12).build(js, ja).solve(0.0, False)
    d, fail = GBPNormalBuilder(co, msg_iters=12, msg_damping=0.0, ridge=1e-12).build(s, a).solve(0.0, False)
    assert not bool(fail.any())
    _close(d.numpy(), jd, 1e-10)
    dd, _ = DenseNormalBuilder(co).build(s, a).solve(0.0, False)
    np.testing.assert_allclose(d.numpy(), dd.numpy(), rtol=1e-6, atol=1e-8)


def test_gbp_loopy_solve_matches_jax():
    jobj, obj = _loopy(jt), _loopy(tt)
    kw = dict(max_iterations=15, msg_iters=40, msg_damping=0.4)
    jout, jinfo = jt.GaussianBeliefPropagation(jobj, **kw).optimize()
    out, info = tt.GaussianBeliefPropagation(obj, **kw).optimize()
    gn, _ = tt.GaussNewton(obj, max_iterations=15).optimize()
    for n in (f"x{i}" for i in range(8)):
        _close(out[n].numpy(), jout[n], 1e-8)
        np.testing.assert_allclose(out[n].numpy(), gn[n].numpy(), atol=5e-5)
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=1e-6, atol=1e-14)
    assert bool((info.last_err < 1e-6).all())


def test_gbp_marginals_match_jax_and_dense():
    kw = dict(max_iterations=10, msg_iters=12, msg_damping=0.0, gbp_ridge=1e-12)
    jm = jt.GaussianBeliefPropagation(_chain(jt, n=5)[0], **kw).marginals()
    obj = _chain(tt, n=5)[0]
    gbp = tt.GaussianBeliefPropagation(obj, **kw)
    margs = gbp.marginals()
    out, _ = gbp.optimize()
    co = obj.compile()
    b = co.resolve_batch_size(out)
    cov = np.linalg.inv(DenseNormalBuilder(co).build(co.pack(out, b), co.build_aux(out, b)).AtA.numpy())
    off = 0
    for name in co.var_names:
        dv = co.var_groups[name].dof
        got = margs[name].precision.numpy()
        _close(got, jm[name].precision, 1e-8)
        _close(margs[name].mean[0].numpy(), jm[name].mean[0], 1e-8)
        assert margs[name].name == jm[name].name == f"{name}_belief"
        np.testing.assert_allclose(got, np.linalg.inv(cov[:, off:off + dv, off:off + dv]), rtol=1e-4, atol=1e-6)
        off += dv


@pytest.mark.parametrize("mode", ["unroll", "implicit", "truncated", "dlm"])
def test_gbp_backward_modes_match_jax(mode):
    """The tangent perturbation t of measurement m0_1 (on-manifold
    directions), loss sum(x1^2)."""
    kw = dict(max_iterations=8, msg_iters=10, msg_damping=0.0)
    jobj, obj = _chain(jt, n=4, batch=1)[0], _chain(tt, n=4, batch=1)[0]
    jlayer = jt.TheseusLayer(jt.GaussianBeliefPropagation(jobj, **kw))
    layer = tt.TheseusLayer(tt.GaussianBeliefPropagation(obj, **kw))
    jvalues, values = jobj.default_values(), obj.default_values()
    base = np.asarray(jvalues["m0_1"])
    t0 = np.array([[0.03, -0.02, 0.05]])

    def jloss(t):
        v = dict(jvalues)
        v["m0_1"] = jse2.compose(jnp.asarray(base), jse2.exp(t))
        out, _ = jlayer.forward(v, {"backward_mode": mode})
        return jnp.sum(out["x1"] ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(t0)))
    t = torch.as_tensor(t0).requires_grad_(True)
    v = dict(values)
    v["m0_1"] = se2.compose(torch.as_tensor(base), se2.exp(t))
    out, _ = layer.forward(v, {"backward_mode": mode})
    (got,) = torch.autograd.grad(torch.sum(out["x1"] ** 2), t)
    assert np.abs(want).sum() > 1e-3
    _close(got.numpy(), want, 1e-7)


def test_gbp_rejects_duplicate_var_costs():
    obj, poses = _chain(tt, n=3)
    obj.add(tt.Between(poses[0], poses[0], tt.SE2(name="self_m"), tt.ScaleCostWeight(1.0), name="self_loop"))
    with pytest.raises(ValueError, match="same variable"):
        GBPNormalBuilder(obj.compile())


def test_gbp_per_call_msg_iters_override():
    jobj, obj = _chain(jt, n=5, batch=1)[0], _chain(tt, n=5, batch=1)[0]
    layer = tt.TheseusLayer(tt.GaussianBeliefPropagation(obj, max_iterations=6, msg_iters=1, msg_damping=0.0))
    jlayer = jt.TheseusLayer(jt.GaussianBeliefPropagation(jobj, max_iterations=6, msg_iters=1, msg_damping=0.0))
    _, weak = layer.forward(obj.default_values())
    _, strong = layer.forward(obj.default_values(), {"msg_iters": 30})
    _, jweak = jlayer.forward(jobj.default_values())
    assert float(strong.last_err.max()) < 1e-8
    assert float(strong.last_err.max()) < 0.01 * float(weak.last_err.max())
    np.testing.assert_allclose(weak.last_err.numpy(), np.asarray(jweak.last_err), rtol=1e-8)


@pytest.mark.parametrize("name", ["SE2", "SE3", "SO3"])
def test_local_and_retract_gaussian_match_jax(name):
    jgroup = getattr(jt, name)(name="v").group
    group = tgroup.by_name(name)
    gen = torch.Generator().manual_seed(4)
    var = group.randn(2, generator=gen, dtype=torch.float64, device="cpu")
    mean = group.randn(2, generator=gen, dtype=torch.float64, device="cpu")
    a = np.random.default_rng(1).standard_normal((2, group.dof, group.dof))
    prec = a @ np.swapaxes(a, -1, -2) + np.eye(group.dof)
    jg = JManifoldGaussian(mean=[jnp.asarray(mean.numpy())], precision=jnp.asarray(prec))
    g = tt.ManifoldGaussian(mean=[mean], precision=torch.as_tensor(prec))
    for return_mean in (True, False):
        want = jlocal_gaussian(jgroup, jnp.asarray(var.numpy()), jg, return_mean=return_mean)
        got = tt.local_gaussian(group, var, g, return_mean=return_mean)
        for x, y in zip(got, want):
            _close(x.numpy(), y, 1e-10)
    mean_tp, lam_tp = tt.local_gaussian(group, var, g)
    jback = jretract_gaussian(jgroup, jnp.asarray(var.numpy()), jnp.asarray(mean_tp.numpy()),
                              jnp.asarray(lam_tp.numpy()))
    back = tt.retract_gaussian(group, var, mean_tp, lam_tp)
    _close(back.mean[0].numpy(), jback.mean[0], 1e-10)
    _close(back.precision.numpy(), jback.precision, 1e-10)
    _close(back.mean[0].numpy(), mean.numpy(), 1e-9)  # the round trip
    _close(back.precision.numpy(), prec, 1e-8)
    with pytest.raises(ValueError, match="single-variable"):
        tt.local_gaussian(group, var, tt.ManifoldGaussian(mean=[mean, mean], precision=torch.as_tensor(prec)))
