"""Robust losses and robust cost buckets of theseus_tpu_torch against the JAX package, on the CPU.

The same float64 inputs, made with numpy or by the JAX package's generators
and carried over, go through both packages:

- each loss's `evaluate` / `linearize` and their gradients in x and the log
  radius over a grid that straddles the radius: 1e-13 relative (the same
  elementwise formulas);
- robust buckets (Between per cost, Reprojection per cost and as a cost
  family; whole-cost and per-dimension losses, a GNC loss) in metric and
  linearize mode against the JAX package's compiled objective: 1e-12
  relative to the largest entry. The port runs the fused linearization and
  then the rescale, the JAX package its jacobians function: the same
  values in another rounding order;
- robust bundle-adjustment LM at 8 cameras x 40 points, 5 % outliers, on
  the Schur and the sparse linearization: per-batch final errors to 1e-10
  relative of the JAX package's plateau;
- the properties of tests/core/test_robust_loss.py, on the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.core import robust_loss as jrl
from theseus_tpu.utils.examples.bundle_adjustment import (
    ba_values as jba_values,
    build_ba_objective as jbuild_ba,
    synthetic_ba as jsynthetic_ba,
)
from theseus_tpu.utils.examples.pose_graph import (
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic_pgo,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch.core import robust_loss as prl
from theseus_tpu_torch.utils.convert import ba_problem_from_arrays
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective
from theseus_tpu_torch.utils.examples.pose_graph import pose_values

LOSSES = ["WelschLoss", "HuberLoss", "HingeLoss", "GemanMcClureLoss"]
BA_KEYS = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img", "gt_poses", "gt_points")


def _rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-300), rtol=0)


# ---------------------------------------------------------------------------
# the loss functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("log_radius", [-0.7, 0.0, 1.2])
def test_loss_values_and_gradients_match_jax(name, log_radius):
    """x from 0 to 50 radii, with points just below, at and just above the
    radius; GemanMcClure at mu = 1 and 3."""
    radius = np.exp(log_radius)
    x = radius * np.array([0.0, 1e-3, 0.3, 0.999, 1.0, 1.001, 2.0, 50.0])
    jcls, pcls = getattr(jrl, name), getattr(prl, name)
    mus = (1.0, 3.0) if jcls.is_gnc else (None,)
    for mu in mus:
        extra = () if mu is None else (mu,)
        for fn in ("evaluate", "linearize"):
            jf = lambda xx, lr: getattr(jcls, fn)(xx, lr, *extra)  # noqa: E731
            want = jf(jnp.asarray(x), jnp.asarray(log_radius))
            gx, glr = jax.vmap(jax.grad(jf, argnums=(0, 1)), in_axes=(0, None))(
                jnp.asarray(x), jnp.asarray(log_radius))
            xt = torch.tensor(x, requires_grad=True)
            lrt = torch.tensor(log_radius, dtype=torch.float64, requires_grad=True)
            got = getattr(pcls, fn)(xt, lrt, *extra)
            _rel_close(got, want, 1e-13)
            # (Hinge's linearize reads the radius only in its branch test)
            px, plr = torch.autograd.grad(got.sum(), (xt, lrt), allow_unused=True)
            plr = torch.zeros_like(lrt) if plr is None else plr
            assert bool(torch.isfinite(px).all()) and bool(torch.isfinite(plr))
            _rel_close(px, gx, 1e-13)
            _rel_close(plr, np.sum(np.asarray(glr)), 1e-13)


@pytest.mark.parametrize("name", LOSSES)
def test_linearize_is_derivative_of_evaluate(name):
    """The IRLS contract: linearize(x) == d evaluate / dx."""
    cls = getattr(prl, name)
    x = torch.tensor([1e-3, 0.1, 0.5, 1.0, 2.0, 10.0, 100.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(cls.evaluate(x, 0.3).sum(), x)
    np.testing.assert_allclose(cls.linearize(x.detach(), 0.3).numpy(), g.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_limits(name):
    """rho(0) ~ 0; Welsch and GemanMcClure saturate at the radius, Huber and
    Hinge grow sub-quadratically."""
    cls = getattr(prl, name)
    z = float(cls.evaluate(torch.tensor(0.0, dtype=torch.float64), 0.0))
    assert abs(z) < 1e-6
    big = float(cls.evaluate(torch.tensor(1e4, dtype=torch.float64), 0.0))
    if name in ("WelschLoss", "GemanMcClureLoss"):
        assert big <= 1.0 + 1e-5
    else:
        assert big < 1e4


# ---------------------------------------------------------------------------
# robust cost functions on a vector problem (the JAX package's properties)
# ---------------------------------------------------------------------------
def _vector_problem(name, flatten_dims, batch=3, radius=0.5):
    x = tt.Vector(2, np.zeros((batch, 2)), name="x")
    t = tt.Vector(2, np.random.default_rng(0).normal(size=(batch, 2)), name="t")
    base = tt.Local(x, t, tt.ScaleCostWeight(2.0), name="base")
    robust = tt.RobustCostFunction(base, getattr(prl, name), np.log(radius), flatten_dims=flatten_dims,
                                   name="rob")
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(robust)
    return obj


def _error(obj):
    co = obj.compile()
    vals = obj.default_values()
    b = co.resolve_batch_size(vals)
    return co.error(co.pack(vals, b), co.build_aux(vals, b)), vals


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("flatten_dims", [False, True])
def test_robust_weighted_error_carries_loss_value(name, flatten_dims):
    """sum(robust error^2) per cost == rho(||w e||^2), or sum_i rho((w e)_i^2)
    with flatten_dims."""
    e, vals = _error(_vector_problem(name, flatten_dims))
    got = torch.sum(e**2, dim=-1)
    werr = 2.0 * (torch.as_tensor(vals["x"]) - torch.as_tensor(vals["t"]))
    cls = getattr(prl, name)
    lr = float(np.log(0.5))
    want = (cls.evaluate(werr**2, lr).sum(-1) if flatten_dims else cls.evaluate(torch.sum(werr**2, -1), lr))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-9)


def _solve(obj, opt_cls=tt.GaussNewton, **kw):
    layer = tt.TheseusLayer(opt_cls(obj, linearization="sparse", **kw))
    out, _ = layer.forward()
    return out


@pytest.mark.parametrize("name", [n for n in LOSSES if n != "HingeLoss"])
def test_robust_equals_plain_at_large_radius(name):
    """radius -> inf: rho(x) -> x, so the robust solve is the least-squares
    one. (Hinge is identically 0 below its radius by design.)"""
    obj = _vector_problem(name, False, radius=1e8)
    out = _solve(obj, max_iterations=10)
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(obj.default_values()["t"]), atol=1e-6)


@pytest.mark.parametrize("name", ["WelschLoss", "GemanMcClureLoss"])
def test_robust_downweights_outliers(name):
    """A far-off target contributes ~zero gradient: the solve stays near the
    inlier target instead of the average."""
    x = tt.Vector(2, np.zeros((1, 2)), name="x")
    w = tt.ScaleCostWeight(1.0)
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(tt.Local(x, tt.Vector(2, np.full((1, 2), 0.1), name="t_in"), w, name="inlier"))
    obj.add(tt.RobustCostFunction(tt.Local(x, tt.Vector(2, np.full((1, 2), 100.0), name="t_out"), w,
                                           name="outlier"), getattr(prl, name), np.log(0.5), name="rob_out"))
    out = _solve(obj, tt.LevenbergMarquardt, max_iterations=20, adaptive_damping=True)
    assert float((out["x"] - 0.1).abs().max()) < 1e-2


def test_gnc_needs_a_gnc_loss():
    x = tt.Vector(2, np.zeros((1, 2)), name="x")
    cost = tt.Local(x, np.zeros((1, 2)), name="c")
    with pytest.raises(ValueError, match="GNC"):
        tt.GNCRobustCostFunction(cost, tt.HuberLoss, 0.0, 1.0)


# ---------------------------------------------------------------------------
# robust buckets against the JAX package's compiled objective
# ---------------------------------------------------------------------------
def _compiled(obj, values):
    co = obj.compile()
    vals = obj.default_values(values)
    b = co.resolve_batch_size(vals)
    return co, co.pack(vals, b), co.build_aux(vals, b)


def _hold_buckets(jobj, jvals, pobj, pvals):
    """Metric error and per-bucket linearization of both packages: 1e-12."""
    jco, jstate, jaux = _compiled(jobj, jvals)
    pco, pstate, paux = _compiled(pobj, pvals)
    assert [bk.robust for bk in pco.buckets] == [bk.robust for bk in jco.buckets]
    assert any(bk.robust for bk in pco.buckets)
    _rel_close(pco.error(pstate, paux), jax.jit(jco.error)(jstate, jaux), 1e-12)
    jblocks = jax.jit(jco.linearize_blocks)(jstate, jaux)
    for (pj, pe), (jj, je) in zip(pco.linearize_blocks(pstate, paux), jblocks):
        _rel_close(pe, je, 1e-12)
        for a, b in zip(pj, jj):
            _rel_close(a, b, 1e-12)


def _robust_wrap(jax_side, loss, flatten, gnc):
    """A cost -> its robust wrapper, in one package: per-dimension or
    whole-cost, GNC (mu = 2.5) or not; log radius 0.1."""
    pkg, losses = (jt, jrl) if jax_side else (tt, prl)
    cls = getattr(losses, loss)

    def wrap(cost, name):
        if gnc:
            return pkg.GNCRobustCostFunction(cost, cls, np.full((1, 1), 0.1), np.full((1, 1), 2.5),
                                             flatten_dims=flatten, name=name)
        return pkg.RobustCostFunction(cost, cls, np.full((1, 1), 0.1), flatten_dims=flatten, name=name)

    return wrap


@pytest.mark.parametrize("loss,flatten,gnc", [("HuberLoss", False, False), ("WelschLoss", True, False),
                                              ("GemanMcClureLoss", False, True)])
def test_robust_between_bucket_matches_jax(loss, flatten, gnc):
    """PGO 8 poses x batch 3: a Local prior and every Between cost wrapped."""
    from theseus_tpu.embodied import Between as JBetween, Local as JLocal

    gt, edges, meas, init = jsynthetic_pgo(n_poses=8, batch=3, seed=1, dtype=jnp.float64)
    gt, meas, init = np.array(gt), np.array(meas), np.array(init)
    objs = []
    for jax_side in (True, False):
        pkg, between, local = (jt, JBetween, JLocal) if jax_side else (tt, tt.Between, tt.Local)
        obj = pkg.Objective(dtype=jnp.float64) if jax_side else tt.Objective(dtype=torch.float64, device="cpu")
        poses = [pkg.SE3(name=f"pose_{i}") for i in range(8)]
        obj.add(local(poses[0], gt[0], pkg.ScaleCostWeight(np.asarray(10.0)), name="prior"))
        wrap = _robust_wrap(jax_side, loss, flatten, gnc)
        for ei, (i, j) in enumerate(edges):
            obj.add(wrap(between(poses[i], poses[j], meas[ei], name=f"edge_{ei}"), f"redge_{ei}"))
        objs.append(obj)
    _hold_buckets(objs[0], jpose_values(init), objs[1], pose_values(torch.as_tensor(init)))


@functools.lru_cache(maxsize=None)
def _ba_arrays(cams=5, pts=24, batch=2, outliers=0.1, seed=0):
    jp = jsynthetic_ba(num_cameras=cams, num_points=pts, batch=batch, seed=seed, visibility=0.6,
                       outlier_fraction=outliers, dtype=jnp.float64)
    return jp, {k: np.asarray(getattr(jp, k)) for k in BA_KEYS}


@pytest.mark.parametrize("use_families", [True, False], ids=["family", "per_cost"])
def test_robust_reprojection_bucket_matches_jax(use_families):
    """BA 5 x 24 x batch 2 with 10 % outliers, Huber at log radius 0.3:
    the family path (one stacked bucket, the radius a shared slot) and the
    per-cost path."""
    jp, arrays = _ba_arrays()
    prob = ba_problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    jobj, _, _ = jbuild_ba(jp, robust_loss_cls=jt.HuberLoss, log_loss_radius=0.3, use_families=use_families)
    pobj, _, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu", robust_loss_cls=tt.HuberLoss,
                                    log_loss_radius=0.3, use_families=use_families)
    _hold_buckets(jobj, jba_values(jp, use_families), pobj, ba_values(prob, use_families))


def test_robust_family_radius_slot_is_shared_and_learnable():
    """The family's (1, 1) log radius is a shared aux slot; a tensor that
    requires grad passed in its place reaches the metric's gradient, and a
    per-cost (N, 1, 1) radius is a stacked slot."""
    _, arrays = _ba_arrays()
    prob = ba_problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    obj, _, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu", robust_loss_cls=tt.HuberLoss)
    co = obj.compile()
    bk = co.buckets[1]
    assert bk.robust and not bk.gnc and not bk.aux_slots[-1].stacked and bk.aux_slots[-1].shared
    lr = torch.zeros((1, 1), dtype=torch.float64, requires_grad=True)
    co, state, aux = _compiled(obj, dict(ba_values(prob), obs_log_radius=lr))
    (g,) = torch.autograd.grad(co.error_metric(state, aux).sum(), lr)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    n = len(prob.obs_cam)
    template = obj.cost_functions["obs"].template
    template.aux_vars[-1].tensor = np.zeros((n, 1, 1))
    obj._compiled = None
    assert obj.compile().buckets[1].aux_slots[-1].stacked


# ---------------------------------------------------------------------------
# robust BA LM to the JAX plateau
# ---------------------------------------------------------------------------
ITERS = 25


@functools.lru_cache(maxsize=None)
def _jax_ba_errors(linearization):
    jp, _ = _ba_arrays(8, 40, 2, 0.05, 3)
    jobj, _, _ = jbuild_ba(jp, robust_loss_cls=jt.HuberLoss, log_loss_radius=0.0)
    layer = jt.TheseusLayer(jt.LevenbergMarquardt(jobj, max_iterations=ITERS, adaptive_damping=True,
                                                  linearization=linearization))
    _, info = layer.forward(jba_values(jp))
    return np.asarray(info.err_history)[0], np.asarray(info.last_err)


@pytest.mark.parametrize("linearization", ["schur", "sparse"])
def test_robust_ba_lm_reaches_the_jax_plateau(linearization):
    """8 x 40 x batch 2, 5 % outliers, Huber at radius 1, LM with adaptive
    damping."""
    _, arrays = _ba_arrays(8, 40, 2, 0.05, 3)
    prob = ba_problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    obj, _, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu", robust_loss_cls=tt.HuberLoss)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True,
                                                  linearization=linearization))
    _, info = layer.forward(ba_values(prob))
    first, last = _jax_ba_errors(linearization)
    np.testing.assert_allclose(info.err_history[0].numpy(), first, rtol=1e-12)
    assert bool((info.last_err < 0.1 * info.err_history[0]).all())
    np.testing.assert_allclose(info.last_err.numpy(), last, rtol=1e-10)
