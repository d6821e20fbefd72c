"""The 2-D Lie groups of theseus_tpu_torch, and the SO3 and SE3 functions added beside them, against the JAX package, on the CPU, in float64.

Every SO2 and SE2 function, and each SO3 and SE3 function the port gained
with them, runs on the same numpy inputs in both packages: angles at
exactly 0, inside the Taylor branches (1e-9, 5e-7, 1e-4, 2e-3: both sides
of the se2 near-zero and derivative eps), ordinary ones, and near and at
pi. Values and analytic jacobians agree to 1e-12 (the same closed forms;
libm's sin, cos and atan2 against XLA's differ by an ulp or two). The
jacobians are also held against torch.func.jacrev of the value they
differentiate, to 1e-8: between the se2 near-zero eps (1e-6) and the
derivative eps (1e-3) the closed forms keep a Taylor series while jacrev
differentiates the exact branch of exp, whose 1 - cos(theta) keeps only
eps / theta^2 of relative accuracy (2e-8 at theta = 1e-4, where the two
differ by 2.0e-9). The SE2 and SO2
functions broadcast over leading dims as the compiled objective's (K, B)
bucket operands need, and the gradients of exp, log and local at the
identity are finite.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

from theseus_tpu.lie import group as jgroup
import theseus_tpu_torch as tt
from theseus_tpu_torch import lie

THETAS = np.array([0.0, 1e-9, 5e-7, 1e-4, 2e-3, 0.3, -1.2, 2.5, math.pi - 1e-7, math.pi, -math.pi + 1e-9])
N = len(THETAS)
TOL = dict(rtol=1e-12, atol=1e-12)
JAC_TOL = dict(rtol=1e-8, atol=1e-8)


def _so2(theta):
    return np.stack([np.cos(theta), np.sin(theta)], -1)


def _so3(rng, theta):
    axis = rng.standard_normal((len(theta), 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = torch.as_tensor(axis * theta[:, None])
    return lie.so3.exp(w).numpy(), w.numpy()


def _inputs(name):
    """Named numpy arguments for one group, N elements each."""
    rng = np.random.default_rng({"SO2": 0, "SE2": 1, "SO3": 2, "SE3": 3}[name])
    shuffled = rng.permutation(THETAS)
    if name == "SO2":
        return dict(w=THETAS[:, None], g=_so2(THETAS), g2=_so2(shuffled), p=rng.standard_normal((N, 2)),
                    m_vee=rng.standard_normal((N, 2, 2)), m_proj=rng.standard_normal((N, 2, 2)),
                    mk=rng.standard_normal((N, 2, 3)), eg=rng.standard_normal((N, 2)),
                    graw=_so2(THETAS) * (1 + 1e-3 * rng.standard_normal((N, 1))))
    if name == "SE2":
        t = 3.0 * rng.standard_normal((N, 2))
        g = np.concatenate([t, _so2(THETAS)], -1)
        g2 = np.concatenate([rng.standard_normal((N, 2)), _so2(shuffled)], -1)
        graw = g + np.concatenate([np.zeros((N, 2)), 1e-3 * rng.standard_normal((N, 2))], -1)
        return dict(w=np.concatenate([rng.standard_normal((N, 2)), THETAS[:, None]], -1), g=g, g2=g2,
                    p=rng.standard_normal((N, 2)), m_vee=rng.standard_normal((N, 3, 3)),
                    m_proj=rng.standard_normal((N, 2, 3)), mk=rng.standard_normal((N, 2, 3)),
                    eg=rng.standard_normal((N, 4)), graw=graw)
    r, w = _so3(rng, THETAS)
    r2, _ = _so3(rng, shuffled)
    rraw = r + 1e-3 * rng.standard_normal((N, 3, 3))
    if name == "SO3":
        return dict(w=w, g=r, g2=r2, p=rng.standard_normal((N, 3)), m_vee=rng.standard_normal((N, 3, 3)),
                    mk=rng.standard_normal((N, 3, 2)), graw=rraw)
    cat = lambda rot, t: np.concatenate([rot, t[..., None]], -1)  # noqa: E731
    return dict(w=np.concatenate([rng.standard_normal((N, 3)), w], -1), g=cat(r, rng.standard_normal((N, 3))),
                g2=cat(r2, rng.standard_normal((N, 3))), p=rng.standard_normal((N, 3)),
                m_vee=rng.standard_normal((N, 4, 4)), m_proj=rng.standard_normal((N, 3, 4)),
                mk=rng.standard_normal((N, 3, 2)), graw=cat(rraw, rng.standard_normal((N, 3))))


COMMON = {"exp": ("w",), "jexp": ("w",), "log": ("g",), "jlog": ("g",), "compose": ("g", "g2"),
          "jcompose": ("g", "g2"), "inverse": ("g",), "jinverse": ("g",), "adjoint": ("g",),
          "to_matrix": ("g",), "hat": ("w",), "vee": ("m_vee",), "lift": ("w",), "project": ("m_proj",),
          "left_act": ("g", "mk"), "left_project": ("g", "m_proj"), "egrad_to_tangent": ("g", "eg"),
          "normalize": ("graw",), "check_group_tensor": ("graw",)}
ROTATE = {"rotate": ("g", "p"), "jrotate": ("g", "p"), "unrotate": ("g", "p"), "junrotate": ("g", "p")}
TRANSFORM = {"transform": ("g", "p"), "jtransform": ("g", "p"), "untransform": ("g", "p"),
             "juntransform": ("g", "p")}
FUNCTIONS = {
    "SO2": {**COMMON, **ROTATE},
    "SE2": {**COMMON, **TRANSFORM},
    # the functions SO3 and SE3 gained in the port with the 2-D groups
    "SO3": {"jcompose": ("g", "g2"), "jinverse": ("g",), "vee": ("m_vee",), "lift": ("w",),
            "left_act": ("g", "mk"), "to_matrix": ("g",), "rotation_to_quaternion": ("g",),
            "normalize": ("graw",), "check_group_tensor": ("graw",), **ROTATE},
    "SE3": {"jcompose": ("g", "g2"), "jinverse": ("g",), "hat": ("w",), "vee": ("m_vee",), "lift": ("w",),
            "project": ("m_proj",), "left_act": ("g", "mk"), "to_matrix": ("g",), "normalize": ("graw",),
            "check_group_tensor": ("graw",), **TRANSFORM},
}
CASES = [(g, f) for g, fs in FUNCTIONS.items() for f in fs]


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [leaf for e in x for leaf in _leaves(e)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def _check_same(got, want, tol=TOL):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("group,fn", CASES, ids=[f"{g}.{f}" for g, f in CASES])
def test_function_matches_jax(group, fn):
    args = [_inputs(group)[k] for k in FUNCTIONS[group][fn]]
    got = getattr(getattr(lie, group.lower()), fn)(*map(torch.as_tensor, args))
    want = getattr(getattr(jgroup, group).mod, fn)(*map(jnp.asarray, args))
    _check_same(got, want)


@pytest.mark.parametrize("group", ["SO2", "SE2", "SO3", "SE3"])
def test_by_name_and_group_namespace(group):
    """by_name resolves the four groups and Rn*; the derived ops (jbetween,
    jlocal, retract, transform through the namespace) equal JAX's."""
    ours, theirs = lie.by_name(group), jgroup.by_name(group)
    assert (ours.name, ours.dof, ours.shape) == (theirs.name, theirs.dof, theirs.shape)
    assert getattr(tt.lie, group) is ours
    x = _inputs(group)
    a, b, w = (torch.as_tensor(x[k]) for k in ("g", "g2", "w"))
    for op, args in (("jbetween", (a, b)), ("jlocal", (a, b)), ("local", (a, b)), ("retract", (a, 0.1 * w)),
                     ("transform", (a, torch.as_tensor(x["p"]))), ("jtransform", (a, torch.as_tensor(x["p"])))):
        _check_same(getattr(ours, op)(*args), getattr(theirs, op)(*(jnp.asarray(t.numpy()) for t in args)))
    assert lie.by_name("Rn5") is lie.euclidean(5) and lie.Point2 is lie.euclidean(2)


def test_euclidean_group_matches_jax():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 3, 5))
    ours, theirs = lie.euclidean(5), jgroup.euclidean(5)
    for op, args in (("jexp", (a,)), ("jcompose", (a, b)), ("jinverse", (a,)), ("jlocal", (a, b)),
                     ("normalize", (a,)), ("retract", (a, b))):
        _check_same(getattr(ours, op)(*map(torch.as_tensor, args)), getattr(theirs, op)(*map(jnp.asarray, args)))


# ---------------------------------------------------------------------------
# broadcasting over (K, B) leading dims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group", ["SO2", "SE2"])
@pytest.mark.parametrize("fn", ["compose", "jcompose", "between", "local", "jlocal", "transform", "jtransform",
                                "untransform", "juntransform"])
def test_broadcasts_like_jax(group, fn):
    x = _inputs(group)
    a = x["g"][:3, None]  # (3, 1, *shape) against (1, 4, *shape)
    b = x["g2"][None, 4:8]
    if "transform" in fn:
        b = x["p"][None, 4:8]
    ours, theirs = lie.by_name(group), jgroup.by_name(group)
    got = getattr(ours, fn)(torch.as_tensor(a), torch.as_tensor(b))
    _check_same(got, getattr(theirs, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert _leaves(got)[-1].shape[:2] == (3, 4)


# ---------------------------------------------------------------------------
# analytic jacobians against torch.func.jacrev
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group", ["SO2", "SE2", "SO3", "SE3"])
def test_analytic_jacobians_match_jacrev(group):
    g_ = lie.by_name(group)
    x = {k: torch.as_tensor(v) for k, v in _inputs(group).items()}
    g, g2, w, p = x["g"], x["g2"], x["w"], x["p"]
    zero = torch.zeros(g.shape[0], g_.dof, dtype=torch.float64)

    def at(fn, *args):  # d/d delta of log(fn(args)^-1 fn(args with g -> g exp(delta)))
        def f(i):
            def inner(d):
                moved = fn(g_.retract(args[0][i], d), *(a[i] for a in args[1:]))
                return g_.local(fn(*(a[i] for a in args)), moved)
            return inner
        return torch.stack([jacrev(f(i))(zero[i]) for i in range(g.shape[0])])

    if group in ("SO2", "SE2"):
        (jexp,), _ = g_.jexp(w)
        want = torch.stack([jacrev(lambda d, i=i: g_.local(g_.exp(w[i]), g_.exp(w[i] + d)))(zero[i])
                            for i in range(len(w))])
        np.testing.assert_allclose(jexp.numpy(), want.numpy(), **JAC_TOL)
        (jlog,), _ = g_.jlog(g)
        want = torch.stack([jacrev(lambda d, i=i: g_.log(g_.retract(g[i], d)))(zero[i]) for i in range(len(g))])
        np.testing.assert_allclose(jlog.numpy(), want.numpy(), **JAC_TOL)
    (j1, j2), _ = g_.jcompose(g, g2)
    np.testing.assert_allclose(j1.numpy(), at(g_.compose, g, g2).numpy(), **JAC_TOL)
    np.testing.assert_allclose(j2.numpy(), at(lambda b, a: g_.compose(a, b), g2, g).numpy(), **JAC_TOL)
    (ji,), _ = g_.jinverse(g)
    np.testing.assert_allclose(ji.numpy(), at(g_.inverse, g).numpy(), **JAC_TOL)
    for name, fn in (("jtransform", g_.transform), ("juntransform", g_.untransform)):
        (jg, jp), _ = getattr(g_, name)(g, p)
        want_g = torch.stack([jacrev(lambda d, i=i: fn(g_.retract(g[i], d), p[i]))(zero[i]) for i in range(len(g))])
        want_p = torch.stack([jacrev(lambda q, i=i: fn(g[i], q))(p[i]) for i in range(len(g))])
        np.testing.assert_allclose(jg.numpy(), want_g.numpy(), **JAC_TOL)
        np.testing.assert_allclose(jp.numpy(), want_p.numpy(), **JAC_TOL)


@pytest.mark.parametrize("group", ["SO2", "SE2", "SO3", "SE3"])
def test_gradients_at_the_identity_are_finite(group):
    g_ = lie.by_name(group)
    x = torch.zeros(2, g_.dof, dtype=torch.float64, requires_grad=True)
    e = g_.identity(2, dtype=torch.float64, device="cpu").clone().requires_grad_(True)
    other = g_.identity(2, dtype=torch.float64, device="cpu").clone().requires_grad_(True)
    c = torch.as_tensor(np.random.default_rng(5).standard_normal((2,) + g_.shape))  # sum() sees no hat(w)
    (gx,) = torch.autograd.grad((g_.exp(x) * c).sum(), x)
    (ge,) = torch.autograd.grad(g_.log(e).sum(), e)
    ga, gb = torch.autograd.grad((g_.local(e, other) ** 2).sum() + g_.local(e, other).sum(), (e, other))
    for t in (gx, ge, ga, gb):
        assert bool(torch.isfinite(t).all())
    assert float(gx.abs().sum()) > 0 and float(ge.abs().sum()) > 0


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group", ["SO2", "SE2", "SO3", "SE3"])
def test_identity_rand_randn(group):
    g_ = lie.by_name(group)
    ident = g_.identity(3, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(ident.numpy(), np.asarray(jgroup.by_name(group).identity(3, dtype=jnp.float64)))
    for fn in (g_.rand, g_.randn):
        a = fn(5, generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
        b = fn(5, generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
        assert tuple(a.shape) == (5,) + g_.shape and a.dtype == torch.float64
        assert bool(g_.mod.check_group_tensor(a).all())
        np.testing.assert_array_equal(a.numpy(), b.numpy())
