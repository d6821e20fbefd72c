"""Autodiff cost functions of theseus_tpu_torch against the analytic jacobians and the JAX package, on the CPU, in float64.

- An `AutoDiffCostFunction` Between (SE3 local of the measurement to
  v1^{-1} v2), by torch.func.jacfwd ("fwd") and jacrev ("rev"), against the
  analytic Between bucket (the Between kernel's twin): 1e-10 at random poses
  and at an exact identity (where the Lie exp/log take their analytic JVP
  rules, as the JAX package's custom_jvp does), with a measurement per cost
  (mapped) and one shared by all costs (unmapped under vmap).
- The repair of the Lie autograd Functions under torch.func: the gradient
  of se3.log(t^{-1} exp(d)) at d = 0 and t = identity, through vmap, is
  finite and equals the JAX package's gradient (1e-12); so do jacfwd and
  jacrev of SE3 and SO3 exp/log at zero and random tangents.
- A robust wrapper around an autodiff cost linearizes as around the
  analytic one (1e-10) and solves on the default dense path.
- A CostFunction subclass that defines only `error_impl` takes the same
  autodiff fallback; costs bucket together only with the same err_fn and
  autograd mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu import lie as jlie
import theseus_tpu_torch as tt
from theseus_tpu_torch.lie import SE3 as G
from theseus_tpu_torch.lie import se3, so3

K, B = 5, 3


def _between_err(optim, aux):
    v1, v2 = optim
    (meas,) = aux
    return G.local(meas, G.between(v1, v2))


def _poses(rng, shape, scale):
    return se3.exp(torch.as_tensor(scale * rng.standard_normal(shape + (6,))))


def _between_problem(kind, mode="fwd", identity=False, shared_meas=False, seed=0):
    """K Between costs over a chain of K + 1 SE3 variables at batch B: the
    analytic cost, or the autodiff one with `mode`."""
    rng = np.random.default_rng(seed)
    poses = _poses(rng, (K + 1, B), 0.0 if identity else 0.8)
    meas = _poses(rng, (1 if shared_meas else K, B), 0.0 if identity else 0.5)
    xs = [tt.SE3(name=f"x{i}") for i in range(K + 1)]
    shared = tt.Variable(meas[0], name="m") if shared_meas else None
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    for i in range(K):
        m = shared if shared_meas else tt.Variable(meas[i], name=f"m{i}")
        if kind == "analytic":
            obj.add(tt.Between(xs[i], xs[i + 1], m, name=f"b{i}"))
        else:
            obj.add(tt.AutoDiffCostFunction([xs[i], xs[i + 1]], 6, _between_err, aux_vars=[m],
                                            name=f"b{i}", autograd_mode=mode))
    return obj, {f"x{i}": poses[i] for i in range(K + 1)}


def _linearize(obj, inputs):
    co = obj.compile()
    values = obj.default_values(inputs)
    state, aux = co.pack(values, B), co.build_aux(values, B)
    (bucket,) = co.linearize_blocks(state, aux)
    return bucket, co.error(state, aux)


@pytest.mark.parametrize("mode", ["fwd", "rev"])
@pytest.mark.parametrize("identity", [False, True], ids=["random", "identity"])
@pytest.mark.parametrize("shared_meas", [False, True], ids=["meas_per_cost", "meas_shared"])
def test_autodiff_between_matches_analytic(mode, identity, shared_meas):
    obj, inputs = _between_problem("autodiff", mode, identity, shared_meas)
    (jacs, err), metric = _linearize(obj, inputs)
    aobj, _ = _between_problem("analytic", identity=identity, shared_meas=shared_meas)
    (ajacs, aerr), ametric = _linearize(aobj, inputs)
    assert len(obj.compile().buckets) == 1 and jacs[0].shape == (K, B, 6, 6)
    for j, aj in zip(jacs, ajacs):
        assert torch.isfinite(j).all()
        np.testing.assert_allclose(j.numpy(), aj.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(err.numpy(), aerr.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(metric.numpy(), ametric.numpy(), rtol=1e-10, atol=1e-12)
    if identity:
        np.testing.assert_allclose(jacs[1].numpy(), np.broadcast_to(np.eye(6), (K, B, 6, 6)), atol=1e-12)
        np.testing.assert_allclose(jacs[0].numpy(), -jacs[1].numpy(), atol=1e-12)


def test_vmapped_identity_gradient_is_finite_and_matches_jax():
    """The probe of the repair: under vmap a tensor reports
    requires_grad=False, and the plain log at the identity gives NaN."""
    d = np.zeros((4, 6))
    t = np.broadcast_to(np.concatenate([np.eye(3), np.zeros((3, 1))], 1), (4, 3, 4)).copy()
    t[1:] = np.asarray(se3.exp(torch.as_tensor(0.3 * np.random.default_rng(1).standard_normal((3, 6)))))

    def f(dd, tt_):
        return se3.log(se3.compose(se3.inverse(tt_), se3.exp(dd)))

    tg = torch.as_tensor(t).requires_grad_(True)
    w = torch.as_tensor(np.random.default_rng(2).standard_normal((4, 6)))
    (torch.func.vmap(f)(torch.as_tensor(d), tg) * w).sum().backward()

    def jf(dd, tt_):
        return jlie.se3.log(jlie.se3.compose(jlie.se3.inverse(tt_), jlie.se3.exp(dd)))

    want = jax.grad(lambda tt_: jnp.sum(jax.vmap(jf)(jnp.asarray(d), tt_) * jnp.asarray(w.numpy())))(jnp.asarray(t))
    assert torch.isfinite(tg.grad).all()
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op", ["se3_exp", "se3_log", "so3_exp", "so3_log"])
@pytest.mark.parametrize("at_zero", [True, False], ids=["zero", "random"])
def test_lie_jacfwd_jacrev_match_jax(op, at_zero):
    """torch.func.jacfwd takes the Functions' jvp (the JAX custom JVP rule),
    jacrev their backward: both equal jax.jacfwd of the JAX op."""
    rng = np.random.default_rng(3)
    mod, jmod = (se3, jlie.se3) if op.startswith("se3") else (so3, jlie.so3)
    dof = 6 if op.startswith("se3") else 3
    tangent = np.zeros(dof) if at_zero else 0.7 * rng.standard_normal(dof)
    if op.endswith("exp"):
        x = tangent
    else:
        x = np.asarray(mod.exp(torch.as_tensor(tangent)))
    fn, jfn = getattr(mod, op[4:]), getattr(jmod, op[4:])
    want = np.asarray(jax.jacfwd(jfn)(jnp.asarray(x)))
    for jac_op in (torch.func.jacfwd, torch.func.jacrev):
        got = jac_op(fn)(torch.as_tensor(x))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_robust_autodiff_cost_matches_robust_analytic():
    """HuberLoss around the autodiff and the analytic Between: the same
    rescaled linearization, and the dense solve converges."""
    def robust(kind):
        obj, inputs = _between_problem(kind)
        robust_obj = tt.Objective(dtype=torch.float64, device="cpu")
        for cf in obj.cost_functions.values():
            robust_obj.add(tt.RobustCostFunction(cf, tt.HuberLoss, np.log(0.3), name=f"r_{cf.name}"))
        return robust_obj, inputs

    obj, inputs = robust("autodiff")
    aobj, _ = robust("analytic")
    (jacs, err), metric = _linearize(obj, inputs)
    (ajacs, aerr), ametric = _linearize(aobj, inputs)
    for j, aj in zip(jacs, ajacs):
        np.testing.assert_allclose(j.numpy(), aj.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(err.numpy(), aerr.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(metric.numpy(), ametric.numpy(), rtol=1e-10, atol=1e-12)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=30, adaptive_damping=True))
    _, info = layer.forward(inputs)
    assert torch.isfinite(info.last_err).all()
    assert (info.last_err < info.err_history[0]).all()


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_autodiff_jacobian_derivative_matches_jax(mode):
    """The derivative of the autodiff jacobians with respect to an aux
    input (a measurement), as the unrolled and implicit backward take it:
    reverse over jacfwd or jacrev, through the Lie rules, equals the JAX
    package's, 1e-10."""
    import theseus_tpu as jt

    obj, inputs = _between_problem("autodiff", mode)
    rng = np.random.default_rng(8)
    w = rng.standard_normal((B, 6 * K, 6 * (K + 1)))
    meas = {n: v.tensor for n, v in obj.aux_vars.items() if n.startswith("m")}
    leaves = {n: torch.as_tensor(np.asarray(t)).requires_grad_(True) for n, t in meas.items()}
    co = obj.compile()
    values = obj.default_values(dict(inputs, **leaves))
    a, _ = co.dense_A_b(co.pack(values, B), co.build_aux(values, B))
    grads = torch.autograd.grad((a * torch.as_tensor(w)).sum(), list(leaves.values()))

    xs = [jt.SE3(name=f"x{i}") for i in range(K + 1)]
    jobj = jt.Objective(dtype=jnp.float64)
    for i in range(K):
        jobj.add(jt.AutoDiffCostFunction(
            [xs[i], xs[i + 1]], 6,
            lambda o, a: jlie.SE3.local(a[0], jlie.SE3.between(o[0], o[1])),
            aux_vars=[jt.Variable(jnp.asarray(np.asarray(meas[f"m{i}"])), name=f"m{i}")],
            name=f"b{i}", autograd_mode=mode))
    jco = jobj.compile()

    def jf(ms):
        vals = jobj.default_values(dict({k: jnp.asarray(v.numpy()) for k, v in inputs.items()}, **ms))
        ja, _ = jco.dense_A_b(jco.pack(vals, B), jco.build_aux(vals, B))
        return jnp.sum(ja * w)

    want = jax.grad(jf)({n: jnp.asarray(np.asarray(t)) for n, t in meas.items()})
    for n, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), rtol=1e-10, atol=1e-10)


class _Offset(tt.CostFunction):
    """A per-instance residual with no analytic jacobians: the autodiff
    fallback of CostFunction.jacobians_fn."""

    def __init__(self, v, target, name=None):
        super().__init__([v], [target], name=name)

    def dim(self):
        return 3

    def error_impl(self, optim, aux):
        (x,) = optim
        (t,) = aux
        return torch.sin(x) * x - t


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_subclass_without_jacobians_takes_autodiff(mode):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 3))
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    v = tt.Vector(3, name="x")
    cost = _Offset(v, tt.Variable(rng.standard_normal((B, 3)), name="t"), name="off")
    cost.autograd_mode = mode
    obj.add(cost)
    (jacs, err), _ = _linearize(obj, {"x": x})
    want = np.einsum("bi,ij->bij", np.cos(x) * x + np.sin(x), np.eye(3))
    np.testing.assert_allclose(jacs[0][0].numpy(), want, rtol=1e-12, atol=1e-12)


def test_schema_buckets_by_err_fn_and_mode():
    x, y = tt.Vector(2, name="x"), tt.Vector(2, name="y")

    def e1(o, a):
        return o[0] - o[1]

    def e2(o, a):
        return o[0] + o[1]

    costs = [tt.AutoDiffCostFunction([x, y], 2, e1, name="a"),
             tt.AutoDiffCostFunction([y, x], 2, e1, name="b"),
             tt.AutoDiffCostFunction([x, y], 2, e2, name="c"),
             tt.AutoDiffCostFunction([x, y], 2, e1, name="d", autograd_mode="rev")]
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    for c in costs:
        obj.add(c)
    assert [bk.k for bk in obj.compile().buckets] == [2, 1, 1]
    with pytest.raises(ValueError):
        tt.AutoDiffCostFunction([x], 2, e1, autograd_mode="central")
