"""The bundle-adjustment backward of theseus_tpu_torch against the JAX package, on the CPU.

- the Reprojection Function (`ops/twin_vjp.py`): `torch.autograd.gradcheck` on
  its CPU (twin) path, with stacked and shared aux, and its VJP against
  `jax.vjp` of the JAX package's `_reference_linearize` (its `_fused_bwd`):
  1e-12 relative to the largest entry, the same closed form.
- `_SchurSolve`: d x / d AtA and d x / d Atb of the damped Schur solve on
  the JAX package's assembled system against `jax.vjp` of the JAX Schur
  solve (which differentiates its plain ops), on the dense-W path and on
  the chunked path (a zero `SCHUR_DENSE_BUDGET_BYTES`): 1e-9 relative, the
  tolerance of the forward step in tests/test_torch_schur.py.
- d loss / d log_radius of a robust (Huber) BA layer, 6 cameras x 30
  points x batch 2 with 10 % outliers, Schur linearization, in the four
  backward modes against `jax.grad` of the JAX layer: 1e-8 relative. Both
  problems carry the scale pin of tests/test_torch_schur.py (without it the
  undamped systems of the implicit and DLM steps are singular).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu import config as jconfig
from theseus_tpu import lie as jlie
from theseus_tpu.ops.pallas_reprojection import _reference_linearize
from theseus_tpu.optim.schur import SchurNormal as JSchurNormal
from theseus_tpu.optim.schur import SchurNormalBuilder as JSchurBuilder
from theseus_tpu.optim.schur import eliminate_points as jeliminate
from theseus_tpu.utils.examples.bundle_adjustment import (
    ba_values as jba_values,
    build_ba_objective as jbuild,
    synthetic_ba as jsynthetic,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.ops.reprojection import reprojection_linearize
from theseus_tpu_torch.optim.schur import SchurNormal, SchurNormalBuilder, eliminate_points
from theseus_tpu_torch.utils.convert import ba_problem_from_arrays
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective

BA_KEYS = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img", "gt_poses", "gt_points")


def _rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-300), rtol=0)


# ---------------------------------------------------------------------------
# the Reprojection Function
# ---------------------------------------------------------------------------
def _reprojection_inputs(K=5, B=2, seed=0, shared=False):
    """pose, point, focal, feat, k1, k2 as float64 numpy arrays; points ~5
    units ahead of each camera; shared: focal, k1, k2 one (B, 1) value."""
    rng = np.random.default_rng(seed)
    pose = np.array(jax.vmap(jax.vmap(jlie.se3.exp))(jnp.asarray(0.2 * rng.standard_normal((K, B, 6)))))
    p_cam = rng.uniform(-1.0, 1.0, (K, B, 3)) + np.array([0.0, 0.0, -5.0])
    point = np.einsum("kbji,kbj->kbi", pose[..., :3], p_cam - pose[..., 3])
    kshape = (B, 1) if shared else (K, B, 1)
    focal = 1000.0 + 50.0 * rng.standard_normal(kshape)
    k1, k2 = 0.1 * rng.standard_normal(kshape), 0.01 * rng.standard_normal(kshape)
    feat = 200.0 * rng.standard_normal((K, B, 2))
    return pose, point, focal, feat, k1, k2


@pytest.mark.parametrize("shared", [False, True], ids=["stacked", "shared"])
def test_reprojection_function_gradcheck(shared):
    args = [torch.tensor(a, requires_grad=True) for a in _reprojection_inputs(K=3, shared=shared)]
    assert torch.autograd.gradcheck(reprojection_linearize, args, eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shared", [False, True], ids=["stacked", "shared"])
def test_reprojection_function_vjp_matches_jax(shared):
    args = _reprojection_inputs(K=7, B=3, seed=1, shared=shared)
    K = args[0].shape[0]
    rng = np.random.default_rng(2)
    cots = (rng.standard_normal((K, 3, 2, 6)), rng.standard_normal((K, 3, 2, 3)), rng.standard_normal((K, 3, 2)))
    jargs = [jnp.asarray(np.broadcast_to(a, (K,) + a.shape) if a.ndim == 2 else a) for a in args]
    want = jax.jit(lambda a, c: jax.vjp(_reference_linearize, *a)[1](c))(
        jargs, tuple(jnp.asarray(c) for c in cots))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = torch.autograd.grad(reprojection_linearize(*targs), targs, [torch.as_tensor(c) for c in cots])
    for g, w, a in zip(got, want, args):
        # a shared aux's gradient is the sum over the observations
        _rel_close(g, np.sum(np.asarray(w), axis=0) if a.ndim == 2 else w, 1e-12)


# ---------------------------------------------------------------------------
# the Schur solve's backward
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ba(cams=5, pts=24, batch=2, outliers=0.0, seed=0):
    """The JAX problem and the port's copy of its arrays."""
    jp = jsynthetic(num_cameras=cams, num_points=pts, batch=batch, seed=seed, visibility=0.6,
                    outlier_fraction=outliers, dtype=jnp.float64)
    return jp, ba_problem_from_arrays({k: np.array(getattr(jp, k)) for k in BA_KEYS}, dtype=torch.float64,
                                      device="cpu")


def _scale_pin(pkg, obj, pts, target):
    """A Local prior (weight 10) on landmark 0: fixes the scale that the
    camera-0 gauge leaves free."""
    if pkg is jt:
        obj.add(jt.Local(pts[0], target, jt.ScaleCostWeight(jnp.asarray(10.0, jnp.float64)), name="scale_pin"))
    else:
        obj.add(tt.Local(pts[0], target.numpy(), tt.ScaleCostWeight(10.0), name="scale_pin"))


@functools.lru_cache(maxsize=None)
def _jax_system():
    jp, _ = _ba()
    jobj, _, jpts = jbuild(jp, gauge_target=jp.gt_poses[0])
    _scale_pin(jt, jobj, jpts, jp.gt_points[0])
    jco = jobj.compile()
    vals = jobj.default_values(jba_values(jp))
    jbld = JSchurBuilder(jco, jeliminate)
    build = jax.jit(lambda st, ax: (lambda ns: (ns.ata, ns.atb_blocks))(jbld.build(st, ax)))
    ata, atb = build(jco.pack(vals, 2), jco.build_aux(vals, 2))
    return jbld, np.array(ata), np.array(atb)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_schur_solve_gradients_match_jax(path):
    jbld, ata, atb = _jax_system()
    _, prob = _ba()
    obj, _, pts = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0])
    _scale_pin(tt, obj, pts, prob.gt_points[0])
    bld = SchurNormalBuilder(obj.compile(), eliminate_points)
    assert bld.pattern.pair_slot == jbld.pattern.pair_slot
    budget = 0 if path == "chunked" else config.SCHUR_DENSE_BUDGET_BYTES
    g = np.random.default_rng(5).standard_normal((2, bld.total_dof))
    old = (jconfig.SCHUR_DENSE_BUDGET_BYTES, config.SCHUR_DENSE_BUDGET_BYTES)
    jconfig.set_schur_dense_budget(budget)
    config.set_schur_dense_budget(budget)
    try:
        assert bld.use_dense_elimination(2, torch.float64) == (path == "dense")

        def jax_vjp(a, b, cot):
            x, vjp = jax.vjp(lambda a, b: JSchurNormal(jbld, a, b).solve(1e-3, True)[0], a, b)
            return x, vjp(cot)

        jx, (jd_ata, jd_atb) = jax.jit(jax_vjp)(jnp.asarray(ata), jnp.asarray(atb), jnp.asarray(g))
        ata_t, atb_t = torch.tensor(ata, requires_grad=True), torch.tensor(atb, requires_grad=True)
        x, _ = SchurNormal(bld, ata_t, atb_t).solve(1e-3, True)
        d_ata, d_atb = torch.autograd.grad(x, (ata_t, atb_t), torch.as_tensor(g))
    finally:
        jconfig.set_schur_dense_budget(old[0])
        config.set_schur_dense_budget(old[1])
    _rel_close(x, jx, 1e-9)
    _rel_close(d_atb, jd_atb, 1e-9)
    _rel_close(d_ata, jd_ata, 1e-9)


def test_schur_solve_backward_reuses_the_factor(monkeypatch):
    """backward() eliminates and factors nothing: one apply of the saved
    factors per cotangent."""
    _, ata, atb = _jax_system()
    _, prob = _ba()
    obj, _, pts = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0])
    _scale_pin(tt, obj, pts, prob.gt_points[0])
    ns = SchurNormal(SchurNormalBuilder(obj.compile(), eliminate_points), torch.as_tensor(ata),
                     torch.tensor(atb, requires_grad=True))
    x, _ = ns.solve(1e-3, True)
    calls = []
    monkeypatch.setattr(SchurNormal, "_prepare_apply", lambda *a: calls.append("prepare"))
    monkeypatch.setattr(torch.linalg, "cholesky_ex", lambda *a, **k: calls.append("cholesky"))
    (d_atb,) = torch.autograd.grad(x.sum(), ns.atb_blocks)
    assert calls == [] and bool(torch.isfinite(d_atb).all())


# ---------------------------------------------------------------------------
# d loss / d log_radius through a robust BA layer
# ---------------------------------------------------------------------------
LOG_RADIUS = 0.4
SOLVERS = {"implicit": 15, "unroll": 4, "truncated": 4, "dlm": 15}


@functools.lru_cache(maxsize=None)
def _jax_radius_grad(mode):
    jp, _ = _ba(6, 30, 2, 0.1, 4)
    jobj, _, jpts = jbuild(jp, robust_loss_cls=jt.HuberLoss, log_loss_radius=LOG_RADIUS,
                           gauge_target=jp.gt_poses[0])
    _scale_pin(jt, jobj, jpts, jp.gt_points[0])
    opt = jt.LevenbergMarquardt(jobj, max_iterations=SOLVERS[mode], adaptive_damping=True,
                                linearization="schur")
    layer = jt.TheseusLayer(opt)
    co = jobj.compile()
    values = jobj.default_values(jba_values(jp))
    state = co.pack(values, 2)

    def loss(log_radius):
        aux = co.build_aux(dict(values, obs_log_radius=jnp.reshape(log_radius, (1, 1))), 2)
        carry = layer.solve_state(state, aux, mode, opt.opts, 2)
        d = jax.vmap(jax.vmap(jlie.SE3.local))(carry["state"]["SE3"], jp.gt_poses)
        return jnp.mean(jnp.sum(d * d, -1))

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(LOG_RADIUS))
    return float(value), float(grad)


@pytest.mark.parametrize("mode", ["implicit", "unroll", "truncated", "dlm"])
def test_robust_ba_radius_gradient_matches_jax(mode):
    _, prob = _ba(6, 30, 2, 0.1, 4)
    log_radius = torch.tensor([[LOG_RADIUS]], dtype=torch.float64, requires_grad=True)
    obj, _, pts = build_ba_objective(prob, dtype=torch.float64, device="cpu", robust_loss_cls=tt.HuberLoss,
                                     log_loss_radius=log_radius, gauge_target=prob.gt_poses[0])
    _scale_pin(tt, obj, pts, prob.gt_points[0])
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=SOLVERS[mode], adaptive_damping=True,
                                                  linearization="schur"))
    out, _ = layer.forward(ba_values(prob), optimizer_kwargs={"backward_mode": mode,
                                                              "backward_num_iterations": 2})
    d = se3.log(se3.compose(se3.inverse(out["cam"]), prob.gt_poses))
    loss = torch.mean(torch.sum(d * d, dim=-1))
    (grad,) = torch.autograd.grad(loss, log_radius)
    jloss, jgrad = _jax_radius_grad(mode)
    assert float(grad) != 0.0
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-9)
    np.testing.assert_allclose(float(grad), jgrad, rtol=1e-8)


@pytest.mark.parametrize("backend", ["schur", "sparse"])
def test_failed_batch_element_gets_zero_cotangent(backend):
    """A batch element whose undamped factorization fails (its step is
    zeroed and flagged) contributes zero to the gradient, and the others'
    gradients are those of their own solves: a 0 * NaN through the failed
    factor would otherwise make the gradient of anything shared across the
    batch NaN (as the JAX package's plain-op gradient is there)."""
    from theseus_tpu_torch.optim.normal import SparseNormal, SparseNormalBuilder

    _, ata, atb = _jax_system()
    _, prob = _ba()
    obj, _, pts = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0])
    _scale_pin(tt, obj, pts, prob.gt_points[0])
    co = obj.compile()
    bld = SchurNormalBuilder(co, eliminate_points) if backend == "schur" else SparseNormalBuilder(co)
    normal = SchurNormal if backend == "schur" else SparseNormal
    bad_ata = torch.as_tensor(ata).clone()
    bad_ata[1:, 1] = -bad_ata[1:, 1]  # element 1: negative definite
    g = torch.as_tensor(np.random.default_rng(6).standard_normal((2, bld.total_dof)))
    atb_t = torch.tensor(atb, requires_grad=True)
    x, fail = normal(bld, bad_ata, atb_t).solve(0.0, False)
    assert fail.tolist() == [False, True]
    (d_atb,) = torch.autograd.grad(x, atb_t, g)
    assert bool(torch.isfinite(d_atb).all()) and float(d_atb[:, 1].abs().max()) == 0.0
    one = torch.tensor(atb[:, :1], requires_grad=True)
    x0, _ = normal(bld, torch.as_tensor(ata[:, :1]), one).solve(0.0, False)
    (want,) = torch.autograd.grad(x0, one, g[:1])
    _rel_close(d_atb[:, :1], want.numpy(), 1e-12)
