"""The dense linearization of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The same numpy inputs go through both packages:

- `apply_damping` (ellipsoidal and additive), `damping_diag`, and the
  Cholesky and LU solvers against `theseus_tpu.optim.linear`: 1e-12 (the
  same formulas; the factorizations are LAPACK's on both sides);
- a batch element that cannot be factored (singular, or not positive
  definite: `cholesky_ex` would give it finite garbage) is zeroed and
  flagged while the others match; without `check_singular` it is NaN, as
  in the JAX package;
- the float32 refinement path (the high-precision tier; the JAX package
  refines float32 solves whenever x64 is on): against the JAX package to
  float32 rounding, and nearer the float64 solution than the unrefined
  solve;
- `dense_A_b` (the Between kernel's twin, an autodiff cost, a cost that
  names one variable twice) and `DenseNormal` (solve with rhs_shift, quad,
  diag): 1e-12;
- the tutorials' curve fit (tests/core/test_layer_dense.py) through GN and
  LM against the JAX layer: 1e-9; its outer gradient in the four backward
  modes against `jax.grad` of the JAX layer: 1e-8;
- dense and sparse PGO 8 x 4 in the port: 1e-10; the default is dense.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.optim import linear as jlinear
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.optim import linear
from theseus_tpu_torch.optim.normal import DenseNormalBuilder
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

B, D = 5, 7


def _spd(rng, b=B, d=D, dtype=np.float64):
    a = rng.standard_normal((b, d + 3, d))
    return (np.einsum("bmi,bmj->bij", a, a) + 0.1 * np.eye(d)).astype(dtype)


@pytest.mark.parametrize("ellipsoidal", [True, False])
@pytest.mark.parametrize("per_batch", [False, True])
def test_apply_damping_and_damping_diag_match_jax(ellipsoidal, per_batch):
    rng = np.random.default_rng(0)
    ata = _spd(rng)
    damping = rng.uniform(0.1, 2.0, B) if per_batch else 0.37
    got = linear.apply_damping(torch.as_tensor(ata), torch.as_tensor(damping) if per_batch else damping,
                               ellipsoidal, 1e-8)
    want = jlinear.apply_damping(jnp.asarray(ata), jnp.asarray(damping), ellipsoidal, 1e-8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    diag = np.diagonal(ata, axis1=-2, axis2=-1).copy()
    got = linear.damping_diag(torch.as_tensor(diag), torch.as_tensor(damping) if per_batch else damping,
                              ellipsoidal)
    want = jlinear.damping_diag(jnp.asarray(diag), jnp.asarray(damping), ellipsoidal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("solver", ["cholesky", "lu"])
@pytest.mark.parametrize("ellipsoidal", [True, False])
def test_dense_solvers_match_jax(solver, ellipsoidal):
    rng = np.random.default_rng(1)
    ata, atb = _spd(rng), rng.standard_normal((B, D))
    damping = rng.uniform(1e-3, 1.0, B)
    cls, jcls = ((linear.DenseCholeskySolver, jlinear.DenseCholeskySolver) if solver == "cholesky"
                 else (linear.DenseLUSolver, jlinear.DenseLUSolver))
    delta, bad = cls().solve(torch.as_tensor(ata), torch.as_tensor(atb), torch.as_tensor(damping), ellipsoidal)
    jdelta, jbad = jcls().solve(jnp.asarray(ata), jnp.asarray(atb), jnp.asarray(damping), ellipsoidal)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-12, atol=1e-12)
    assert not bad.any() and not np.asarray(jbad).any()


@pytest.mark.parametrize("solver", ["cholesky", "lu"])
@pytest.mark.parametrize("check_singular", [True, False])
def test_singular_batch_element_zeroed_and_flagged(solver, check_singular):
    """Element 1 is exactly singular (zero), element 3 negative definite
    (cholesky_ex returns a partial factor and info > 0 for it); LU fails
    only on the singular one. The other elements match the JAX package."""
    rng = np.random.default_rng(2)
    ata, atb = _spd(rng), rng.standard_normal((B, D))
    ata[1] = 0.0
    ata[3] = -np.eye(D)
    cls, jcls = ((linear.DenseCholeskySolver, jlinear.DenseCholeskySolver) if solver == "cholesky"
                 else (linear.DenseLUSolver, jlinear.DenseLUSolver))
    delta, bad = cls(check_singular=check_singular).solve(torch.as_tensor(ata), torch.as_tensor(atb))
    jdelta, jbad = jcls(check_singular=check_singular).solve(jnp.asarray(ata), jnp.asarray(atb))
    jdelta = np.asarray(jdelta)
    failed = [1, 3] if solver == "cholesky" else [1]
    ok = [i for i in range(B) if i not in failed]
    np.testing.assert_allclose(delta.numpy()[ok], jdelta[ok], rtol=1e-12, atol=1e-12)
    if check_singular:
        assert bad.tolist() == [i in failed for i in range(B)] == np.asarray(jbad).tolist()
        assert (delta.numpy()[failed] == 0).all() and (jdelta[failed] == 0).all()
    else:
        assert not bad.any()
        assert np.isnan(delta.numpy()[failed]).all() and not np.isfinite(jdelta[failed]).all(axis=-1).any()


def test_float32_refinement_matches_jax():
    """The high-precision tier refines a float32 Cholesky solve with one
    float64 residual sweep, as the JAX package does with x64 on."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((B, D + 3, D)) * np.logspace(0, 2, D)
    ata = np.einsum("bmi,bmj->bij", a, a).astype(np.float32)
    atb = rng.standard_normal((B, D)).astype(np.float32)
    exact = np.linalg.solve(ata.astype(np.float64) + 1e-3 * np.eye(D), atb.astype(np.float64)[..., None])[..., 0]
    solver = linear.DenseCholeskySolver()
    plain, _ = solver.solve(torch.as_tensor(ata), torch.as_tensor(atb), 1e-3)
    config.set_high_precision_tier(True)
    try:
        refined, bad = solver.solve(torch.as_tensor(ata), torch.as_tensor(atb), 1e-3)
    finally:
        config.set_high_precision_tier(False)
    jrefined, _ = jlinear.DenseCholeskySolver().solve(jnp.asarray(ata), jnp.asarray(atb), 1e-3)
    assert refined.dtype == torch.float32 and not bad.any()
    scale = np.abs(exact).max()
    np.testing.assert_allclose(refined.numpy(), np.asarray(jrefined), atol=1e-5 * scale, rtol=0)
    # one sweep takes the error from the float32 solve's to within a few
    # float32 ulp of the output (the solution itself is rounded to float32)
    assert np.abs(refined.numpy() - exact).max() < 0.5 * np.abs(plain.numpy() - exact).max()


def test_full_precision_pin_holds_inside_the_dense_build(monkeypatch):
    """The dense AtA and Atb products run with TF32 off even when the caller
    turned it on; the caller's setting is restored afterwards."""
    obj = _curve_objective(npts=6)
    x, y, _ = _curve_data(batch=2, npts=6)
    co = obj.compile()
    values = obj.default_values({"x": x, "y": y, "ab": np.zeros((2, 2))})
    state, aux = co.pack(values, 2), co.build_aux(values, 2)
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        DenseNormalBuilder(co).build(state, aux)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}


# ---------------------------------------------------------------------------
# the curve fit of tests/core/test_layer_dense.py
# ---------------------------------------------------------------------------
def _curve_data(batch=4, npts=30, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, size=(batch, npts))
    ab = rng.uniform(0.5, 2.0, size=(batch, 2))
    return x, ab[:, :1] * x**2 + ab[:, 1:], ab


def _curve_err(optim, aux):
    (ab,) = optim
    x, y = aux
    return y - (ab[0] * x**2 + ab[1])


def _curve_objective(npts=30, jax_side=False):
    pkg = jt if jax_side else tt
    v = pkg.Vector(2, name="ab")
    x = pkg.Variable(np.zeros((1, npts)), name="x")
    y = pkg.Variable(np.zeros((1, npts)), name="y")
    cost = pkg.AutoDiffCostFunction([v], npts, _curve_err, aux_vars=[x, y], name="fit")
    obj = pkg.Objective(dtype=jnp.float64) if jax_side else tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(cost)
    return obj


@pytest.mark.parametrize("cls", ["GaussNewton", "LevenbergMarquardt"])
def test_curve_fit_matches_jax_layer(cls):
    x, y, ab_true = _curve_data()
    kw = dict(max_iterations=15)
    if cls == "LevenbergMarquardt":
        kw["adaptive_damping"] = True
    jout, jinfo = jt.TheseusLayer(getattr(jt, cls)(_curve_objective(jax_side=True), **kw)).forward(
        {"x": jnp.asarray(x), "y": jnp.asarray(y), "ab": jnp.zeros((4, 2), jnp.float64)})
    opt = getattr(tt, cls)(_curve_objective(), **kw)
    assert opt.linearization == "dense"
    out, info = tt.TheseusLayer(opt).forward({"x": x, "y": y, "ab": np.zeros((4, 2))})
    np.testing.assert_allclose(out["ab"].numpy(), np.asarray(jout["ab"]), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(out["ab"].numpy(), ab_true, atol=1e-6)
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=1e-9, atol=1e-20)
    np.testing.assert_array_equal(info.status.numpy(), np.asarray(jinfo.status))


def test_curve_fit_with_lu_solver_matches_jax():
    """`linear_solver` as in the JAX package: LM on the dense LU solve."""
    x, y, _ = _curve_data()
    kw = dict(max_iterations=15, adaptive_damping=True)
    jout, _ = jt.TheseusLayer(jt.LevenbergMarquardt(_curve_objective(jax_side=True), jlinear.DenseLUSolver(),
                                                    **kw)).forward(
        {"x": jnp.asarray(x), "y": jnp.asarray(y), "ab": jnp.zeros((4, 2), jnp.float64)})
    opt = tt.LevenbergMarquardt(_curve_objective(), tt.DenseLUSolver(), **kw)
    assert isinstance(opt.normal_builder.solver, linear.DenseLUSolver)
    out, _ = tt.TheseusLayer(opt).forward({"x": x, "y": y, "ab": np.zeros((4, 2))})
    np.testing.assert_allclose(out["ab"].numpy(), np.asarray(jout["ab"]), rtol=1e-9, atol=1e-9)


def _jax_outer_grad(mode, x, y, theta):
    obj = _curve_objective(npts=10, jax_side=True)
    opt = jt.GaussNewton(obj, max_iterations=8)
    layer = jt.TheseusLayer(opt)
    co = obj.compile()

    def f(th):
        values = obj.default_values({"x": jnp.asarray(x), "y": th * jnp.asarray(y),
                                     "ab": jnp.zeros((2, 2), jnp.float64)})
        carry = layer.solve_state(co.pack(values, 2), co.build_aux(values, 2), mode, opt.opts, 3)
        return jnp.sum(co.unpack(carry["state"])["ab"] ** 2)

    return float(jax.grad(f)(jnp.asarray(theta, jnp.float64)))


@pytest.mark.parametrize("mode", ["unroll", "implicit", "truncated", "dlm"])
def test_curve_fit_backward_modes_match_jax(mode):
    """theta scales the y data (an aux input): the gradient of sum(ab^2)
    after 8 Gauss-Newton iterations flows through the dense solve."""
    x, y, _ = _curve_data(batch=2, npts=10)
    layer = tt.TheseusLayer(tt.GaussNewton(_curve_objective(npts=10), max_iterations=8))
    theta = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    out, _ = layer.forward({"x": torch.as_tensor(x), "y": theta * torch.as_tensor(y), "ab": np.zeros((2, 2))},
                           optimizer_kwargs={"backward_mode": mode, "backward_num_iterations": 3})
    (g,) = torch.autograd.grad(torch.sum(out["ab"] ** 2), theta)
    want = _jax_outer_grad(mode, x, y, 1.3)
    assert np.isfinite(float(g)) and abs(float(g)) > 1e-3
    np.testing.assert_allclose(float(g), want, rtol=1e-8)


# ---------------------------------------------------------------------------
# dense_A_b and DenseNormal
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _pgo_arrays(n=8, b=4):
    gt, edges, meas, init = synthetic_pose_graph(n, b, seed=5, dtype=torch.float64, device="cpu")
    return gt, edges, meas, init


def _pgo_layer(linearization, n=8, b=4):
    gt, edges, meas, init = _pgo_arrays(n, b)
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=torch.float64, device="cpu")
    return tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=20, adaptive_damping=True,
                                                 linearization=linearization)), pose_values(init)


def test_dense_and_sparse_pgo_agree():
    """PGO 8 x 4 (Between through the kernel's twin, a Local prior): the
    dense and the sparse linearization solve the same system."""
    outs = {}
    for lin in ("dense", "sparse"):
        layer, inputs = _pgo_layer(lin)
        outs[lin] = layer.forward(inputs)
    (d_out, d_info), (s_out, s_info) = outs["dense"], outs["sparse"]
    np.testing.assert_allclose(d_info.last_err.numpy(), s_info.last_err.numpy(), rtol=1e-10, atol=1e-20)
    for k in d_out:
        if k.startswith("pose_"):
            np.testing.assert_allclose(d_out[k].numpy(), s_out[k].numpy(), atol=1e-10)
    np.testing.assert_array_equal(d_info.status.numpy(), s_info.status.numpy())


def _twin_problem(jax_side):
    """Three costs: a cost naming x twice (A's block for x is the sum of
    both slots), x against y, and a Between-like local on a vector."""
    pkg = jt if jax_side else tt
    x, y = pkg.Vector(3, name="x"), pkg.Vector(3, name="y")
    c = pkg.Variable(np.array([[0.3, -0.2, 0.5]]), name="c")
    obj = pkg.Objective(dtype=jnp.float64) if jax_side else tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(pkg.AutoDiffCostFunction([x, x], 3, lambda o, a: o[0] * o[1] - a[0], aux_vars=[c], name="twice"))
    obj.add(pkg.AutoDiffCostFunction([x, y], 3, lambda o, a: o[0] ** 3 - 2.0 * o[1], name="xy"))
    obj.add(pkg.AutoDiffCostFunction([y], 2, lambda o, a: o[0][:2] * o[0][1:], name="y"))
    return obj


def test_dense_A_b_matches_jax_with_repeated_variable():
    rng = np.random.default_rng(6)
    values = {"x": rng.standard_normal((3, 3)), "y": rng.standard_normal((3, 3))}
    out = []
    for jax_side in (True, False):
        obj = _twin_problem(jax_side)
        co = obj.compile()
        vals = obj.default_values({k: (jnp.asarray(v) if jax_side else v) for k, v in values.items()})
        a, b = co.dense_A_b(co.pack(vals, 3), co.build_aux(vals, 3))
        out.append((np.asarray(a), np.asarray(b)))
    (ja, jb), (a, b) = out
    assert a.shape == (3, 8, 6)
    np.testing.assert_allclose(a, ja, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(b, jb, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a[:, :3, :3], 2 * np.einsum("bi,ij->bij", values["x"], np.eye(3)), atol=1e-12)


def test_dense_normal_matches_jax_on_pgo():
    """dense_A_b on PGO 8 x 4 (the Between bucket through the kernel's
    twin), AtA, Atb, quad, diag and the DLM-style shifted solve against the
    JAX package's DenseNormalBuilder on the same arrays."""
    from theseus_tpu.optim.normal import DenseNormalBuilder as JBuilder
    from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild

    gt, edges, meas, init = _pgo_arrays()
    jobj, _ = jbuild(8, edges, jnp.asarray(meas.numpy()), jnp.asarray(gt[0].numpy()), dtype=jnp.float64)
    jco = jobj.compile()
    jvals = jobj.default_values({f"pose_{i}": jnp.asarray(init[i].numpy()) for i in range(8)})
    jns = JBuilder(jco).build(jco.pack(jvals, 4), jco.build_aux(jvals, 4))
    layer, inputs = _pgo_layer("dense")
    co = layer.objective.compile()
    vals = layer.objective.default_values(inputs)
    ns = layer.optimizer.normal_builder.build(co.pack(vals, 4), co.build_aux(vals, 4))
    np.testing.assert_allclose(ns.AtA.numpy(), np.asarray(jns.AtA), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(ns.Atb.numpy(), np.asarray(jns.Atb), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(ns.diag().numpy(), np.asarray(jns.diag()), rtol=1e-12, atol=1e-10)
    v = np.random.default_rng(7).standard_normal((4, co.total_dof))
    np.testing.assert_allclose(ns.quad(torch.as_tensor(v)).numpy(), np.asarray(jns.quad(jnp.asarray(v))),
                               rtol=1e-12)
    shift = 1e-2 * v
    delta, bad = ns.solve(0.5, True, rhs_shift=torch.as_tensor(shift))
    jdelta, _ = jns.solve(0.5, True, rhs_shift=jnp.asarray(shift))
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-10, atol=1e-12)
    assert not bad.any()


def test_default_linearization_is_dense():
    layer, _ = _pgo_layer("dense")
    assert tt.LevenbergMarquardt(layer.objective).linearization == "dense"
    assert tt.GaussNewton(layer.objective).linearization == "dense"
    assert isinstance(tt.GaussNewton(layer.objective).normal_builder, DenseNormalBuilder)
    with pytest.raises(ValueError):
        tt.GaussNewton(layer.objective, linearization="banded")
