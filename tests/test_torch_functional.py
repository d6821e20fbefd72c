"""The functional API, the new variable types and families, the Vector surface, the lie-group checks and LieArray of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The cases of tests/core/test_functional_api.py, tests/core/test_vector_surface.py,
tests/lie/test_checks.py and tests/lie/test_lie_array.py on deterministic
numpy inputs, each result held against the JAX package's on the same
inputs (1e-12). The random constructors are held to shape, dtype, device
and group validity, not to JAX's streams: a torch.Generator and a JAX key
give other numbers. Every name the JAX package exports for these imports
from theseus_tpu_torch, and the constructors run on the card unless a
device is named (without one they raise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.lie import group as jgroup
import theseus_tpu_torch as tt
from theseus_tpu_torch import config, lie
from theseus_tpu_torch.lie import LieArray
from theseus_tpu_torch.lie.checks import check_group, checks_enabled

TOL = dict(rtol=1e-12, atol=1e-12)
GROUPS = ("SO2", "SE2", "SO3", "SE3")


def _elements(group, b=4, seed=0):
    """Deterministic elements: exp of numpy tangents, on both sides."""
    t = 0.7 * np.random.default_rng(seed).standard_normal((b, jgroup.by_name(group).dof))
    return np.array(jgroup.by_name(group).exp(jnp.asarray(t)))


def _var(pkg, group, data, name=None):
    return getattr(pkg, group)(tensor=torch.as_tensor(data) if pkg is tt else jnp.asarray(data), name=name)


@pytest.mark.parametrize("group", GROUPS)
def test_compose_between_inverse_match_jax(group):
    a, b = _elements(group, seed=1), _elements(group, seed=2)
    for fn in ("compose", "between"):
        got = getattr(tt, fn)(_var(tt, group, a), _var(tt, group, b), name="c")
        want = getattr(jt, fn)(_var(jt, group, a), _var(jt, group, b))
        assert got.name == "c" and got.group is lie.by_name(group)
        np.testing.assert_allclose(got.tensor.numpy(), np.asarray(want.tensor), **TOL)
    np.testing.assert_allclose(tt.inverse(_var(tt, group, a)).tensor.numpy(),
                               np.asarray(jt.inverse(_var(jt, group, a)).tensor), **TOL)
    ident = tt.compose(_var(tt, group, a), tt.inverse(_var(tt, group, a)))
    np.testing.assert_allclose(tt.log_map(ident).numpy(), 0.0, atol=1e-12)


@pytest.mark.parametrize("group", GROUPS)
def test_log_exp_adjoint_local_retract_match_jax(group):
    a, b = _elements(group, seed=3), _elements(group, seed=4)
    dof = lie.by_name(group).dof
    delta = 0.1 * np.random.default_rng(5).standard_normal((4, dof))
    va, vb, ja, jb = _var(tt, group, a), _var(tt, group, b), _var(jt, group, a), _var(jt, group, b)
    pairs = [
        (tt.log_map(va), jt.log_map(ja)),
        (tt.adjoint(va), jt.adjoint(ja)),
        (tt.local(va, vb), jt.local(ja, jb)),
        (tt.retract(va, delta).tensor, jt.retract(ja, jnp.asarray(delta)).tensor),
        (tt.exp_map(delta, va).tensor, jt.exp_map(jnp.asarray(delta), ja).tensor),
        (tt.exp_map(delta, lie.by_name(group)).tensor, jt.exp_map(jnp.asarray(delta), jgroup.by_name(group)).tensor),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tt.local(va, tt.retract(va, delta)).numpy(), delta, atol=1e-10)


def test_adjoint_moves_a_tangent_as_conjugation():
    """Adj(g) x = log(g exp(x) g^-1), on SE2 (the case of test_functional_api.py)."""
    a = _var(tt, "SE2", _elements("SE2", b=3, seed=6))
    x = torch.as_tensor(0.2 * np.random.default_rng(0).standard_normal((3, 3)))
    lhs = (tt.adjoint(a) @ x[..., None])[..., 0]
    gx = tt.compose(tt.compose(a, tt.exp_map(x, a)), tt.inverse(a))
    np.testing.assert_allclose(lhs.numpy(), tt.log_map(gx).numpy(), atol=1e-9)


def test_group_mismatch_rejected():
    with pytest.raises(ValueError, match="matching groups"):
        tt.compose(tt.rand_se2(1, device="cpu"), tt.rand_se3(1, device="cpu"))
    with pytest.raises(TypeError):
        tt.log_map(torch.zeros(1, 3))


RAND = [("so2", (2, 2)), ("se2", (2, 4)), ("so3", (2, 3, 3)), ("se3", (2, 3, 4)), ("point2", (2, 2)),
        ("point3", (2, 3))]


@pytest.mark.parametrize("name,shape", RAND, ids=[n for n, _ in RAND])
def test_rand_constructors(name, shape):
    for fn in (getattr(tt, f"rand_{name}"), getattr(tt, f"randn_{name}")):
        v = fn(2, generator=torch.Generator().manual_seed(3), dtype=torch.float64, device="cpu", name="r")
        assert tuple(v.tensor.shape) == shape and v.tensor.dtype == torch.float64
        assert v.tensor.device.type == "cpu" and v.name == "r"
        assert bool(torch.isfinite(tt.log_map(v)).all())
        if hasattr(v.group.mod, "check_group_tensor"):
            assert bool(v.group.mod.check_group_tensor(v.tensor).all())
        again = fn(2, generator=torch.Generator().manual_seed(3), dtype=torch.float64, device="cpu")
        np.testing.assert_array_equal(v.tensor.numpy(), again.tensor.numpy())
        assert fn(2, device="cpu").tensor.dtype == torch.float32


def test_rand_vector():
    v = tt.rand_vector(7, 3, device="cpu")
    assert tuple(v.tensor.shape) == (3, 7) and v.dof == 7
    assert tuple(tt.randn_vector(7, 3, device="cpu").tensor.shape) == (3, 7)


def test_rand_runs_on_the_card_by_default(monkeypatch):
    """device None is the card: without one it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tt.rand_se2(2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tt.randn_so3(2, generator=torch.Generator())
    monkeypatch.setattr(config, "default_device", lambda: torch.device("cpu"))
    assert tt.rand_se2(2).tensor.device.type == "cpu"


# ---------------------------------------------------------------------------
# variables and families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group", GROUPS + ("Point2", "Point3"))
def test_variable_and_family_constructors(group):
    ours, theirs = getattr(tt, group)(name="v"), getattr(jt, group)(name="v")
    assert ours.group.name == theirs.group.name and ours.dof == theirs.dof
    fam, jfam = getattr(tt, f"{group}Family")(5, name="f"), getattr(jt, f"{group}Family")(5, name="f")
    assert (fam.group.name, fam.count, fam.dof) == (jfam.group.name, jfam.count, jfam.dof)
    assert fam[3].name == "f[3]" and fam[3].group is fam.group
    np.testing.assert_array_equal(fam.default(torch.float64, "cpu").numpy(), np.asarray(jfam.default(jnp.float64)))
    # an unbatched element gains the batch dim
    one = getattr(tt, group)(tensor=np.asarray(jgroup.by_name(ours.group.name).identity(dtype=jnp.float64)))
    assert tuple(one.tensor.shape) == (1,) + ours.group.shape


def test_vector_dof_from_the_tensor():
    assert tt.Vector(tensor=np.zeros((2, 5))).dof == 5 == jt.Vector(tensor=np.zeros((2, 5))).dof
    assert tt.Vector(4).dof == 4
    with pytest.raises(ValueError):
        tt.Vector()
    with pytest.raises(ValueError, match="trailing shape"):
        tt.SE2(tensor=np.zeros((1, 3)))


def _v(vals, pkg=tt, name=None):
    return pkg.Vector(tensor=torch.as_tensor(vals, dtype=torch.float64) if pkg is tt else jnp.asarray(vals), name=name)


def test_vector_arithmetic_matches_jax():
    a, b = [[1.0, 2.0], [3.0, 4.0]], [[0.5, -1.0], [2.0, 2.0]]
    ops = [lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * 2.0, lambda x, y: 2.0 * x,
           lambda x, y: x / 2.0, lambda x, y: -x, lambda x, y: abs(-x), lambda x, y: 3.0 - x, lambda x, y: x * y]
    for op in ops:
        got, want = op(_v(a), _v(b)), op(_v(a, jt), _v(b, jt))
        assert got.dof == want.dof
        np.testing.assert_allclose(got.tensor.numpy(), np.asarray(want.tensor), **TOL)


def test_dot_outer_norm_matmul_cat_accessors():
    a, b = _v([[1.0, 2.0]]), _v([[3.0, 4.0]])
    np.testing.assert_allclose(a.dot(b).numpy(), [11.0])
    np.testing.assert_allclose(a.inner(b).numpy(), [11.0])
    np.testing.assert_allclose(a.outer(b).numpy(), [[[3.0, 4.0], [6.0, 8.0]]])
    np.testing.assert_allclose(b.norm().numpy(), [5.0])
    m = torch.tensor([[1.0, 0.0], [0.0, 2.0]], dtype=torch.float64)
    np.testing.assert_allclose((a @ m).tensor.numpy(), [[1.0, 4.0]])
    ab = _v([[1.0, 2.0], [1.0, 2.0]])
    np.testing.assert_allclose((ab @ torch.stack([m, 2 * m])).tensor.numpy(), [[1.0, 4.0], [2.0, 8.0]])
    # numpy operands stay numpy
    h1, h2 = tt.Vector(tensor=np.ones((2, 2)), name="a"), tt.Vector(tensor=np.zeros((2, 3)), name="b")
    c = tt.ManifoldVariable.cat([h1, h2], name="c")
    assert c.dof == 5 and c.tensor.shape == (2, 5) and isinstance(c.tensor, np.ndarray)
    assert isinstance((h1 + h1).tensor, np.ndarray) and isinstance(h1.norm(), np.ndarray)
    assert tt.ManifoldVariable.cat([a, b]).dof == 4
    p2, p3 = tt.Point2(tensor=np.array([[1.0, 2.0]])), tt.Point3(tensor=np.array([[1.0, 2.0, 3.0]]))
    assert (float(p2.x()[0]), float(p2.y()[0]), float(p3.z()[0])) == (1.0, 2.0, 3.0)
    with pytest.raises(AttributeError):
        p2.z()


def test_lie_variables_reject_arithmetic():
    g = tt.SE2(name="g")
    with pytest.raises(TypeError, match="euclidean"):
        g + g
    with pytest.raises(TypeError, match="euclidean and Lie"):
        _v([[1.0, 2.0, 3.0, 4.0]]) + g


def test_arithmetic_result_usable_as_variable():
    """A derived vector enters an objective like any variable."""
    a = _v([[0.0, 0.0]], name="x")
    target = _v([[1.0, 1.0]]) * 2.0
    target.name = "t"
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(tt.Local(a, target, tt.ScaleCostWeight(1.0), name="c"))
    out, _ = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=3)).forward()
    np.testing.assert_allclose(out["x"].numpy(), [[2.0, 2.0]], atol=1e-8)


# ---------------------------------------------------------------------------
# the lie-group checks
# ---------------------------------------------------------------------------
def test_checks_default_off():
    assert not checks_enabled()
    tt.SE3(tensor=torch.ones(1, 3, 4))  # no validation by default


@pytest.mark.parametrize("group", GROUPS)
def test_checks_fire_and_restore(group):
    bad = np.ones((1,) + lie.by_name(group).shape)
    with tt.enable_lie_group_check():
        with pytest.raises(ValueError, match=f"Invalid {group}"):
            getattr(tt, group)(tensor=bad)
        with jt.enable_lie_group_check(), pytest.raises(ValueError):  # the JAX package agrees
            getattr(jt, group)(tensor=jnp.asarray(bad))
        getattr(tt, group)(tensor=torch.as_tensor(_elements(group)))
        getattr(tt, group)(tensor=_elements(group))  # numpy
        with tt.no_lie_group_check():
            getattr(tt, group)(tensor=bad)
        assert checks_enabled()
    assert not checks_enabled()
    with tt.set_lie_group_check_enabled(True):
        assert checks_enabled()
    assert not checks_enabled()


def test_checks_are_a_noop_under_torch_func():
    with tt.enable_lie_group_check():
        def f(x):
            check_group(lie.SE3, x)  # values are not concrete here: must not raise
            return x.sum()

        torch.func.vmap(f)(torch.ones(2, 1, 3, 4))
        torch.func.grad(f)(torch.ones(1, 3, 4))
        with pytest.raises(ValueError):
            f(torch.ones(1, 3, 4))


# ---------------------------------------------------------------------------
# LieArray
# ---------------------------------------------------------------------------
def test_lie_array_closed_ops_and_escape():
    g = LieArray(torch.as_tensor(_elements("SE3", seed=7)), lie.SE3)
    h = LieArray(torch.as_tensor(_elements("SE3", seed=8)), lie.SE3)
    np.testing.assert_allclose((g @ h).as_euclidean().numpy(), lie.SE3.compose(g.data, h.data).numpy(), **TOL)
    np.testing.assert_allclose(g.between(h).log().numpy(), lie.SE3.local(g.data, h.data).numpy(), **TOL)
    with pytest.raises(TypeError):
        g + h
    with pytest.raises(TypeError):
        g * h
    with pytest.raises(TypeError):
        g @ torch.eye(4)
    with pytest.raises(ValueError):
        g.compose(LieArray.rand(lie.SO3, 4, generator=torch.Generator().manual_seed(0),
                                dtype=torch.float64, device="cpu"))
    d = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal((4, 6)))
    np.testing.assert_allclose(g.local(g.retract(d)).numpy(), d.numpy(), atol=1e-9)
    with lie.as_euclidean():
        assert lie.euclidean_enabled()
        np.testing.assert_allclose((g + h).numpy(), (g.data + h.data).numpy())
        np.testing.assert_allclose((g - h).numpy(), (g.data - h.data).numpy())
        np.testing.assert_allclose((g * 2.0).numpy(), (2.0 * g.data).numpy())
    assert not lie.euclidean_enabled()
    assert g[1:3].batch_shape == (2,) and g.shape == (4, 3, 4) and g.dtype == torch.float64


@pytest.mark.parametrize("group", GROUPS)
def test_lie_array_free_functions_match_jax(group):
    a, b = _elements(group, seed=9), _elements(group, seed=10)
    ours = LieArray(torch.as_tensor(a), lie.by_name(group)), lie.from_tensor(torch.as_tensor(b), lie.by_name(group))
    theirs = jt.lie.LieArray(jnp.asarray(a), jgroup.by_name(group)), jt.lie.LieArray(jnp.asarray(b), jgroup.by_name(group))
    p = np.random.default_rng(11).standard_normal((4, 3 if group.endswith("3") else 2))

    def unwrap(x):
        if isinstance(x, (list, tuple)):
            return [y for e in x for y in unwrap(e)]
        x = x.as_euclidean() if isinstance(x, (LieArray, jt.lie.LieArray)) else x
        return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]

    for fn in ("log", "adj", "jlog"):
        for got, want in zip(unwrap(getattr(lie, fn)(ours[0])), unwrap(getattr(jt.lie, fn)(theirs[0]))):
            np.testing.assert_allclose(got, want, **TOL)
    for fn in ("inv", "jinv"):
        for got, want in zip(unwrap(getattr(lie, fn)(ours[0])), unwrap(getattr(jt.lie, fn)(theirs[0]))):
            np.testing.assert_allclose(got, want, **TOL)
    for fn in ("compose", "between", "local", "jcompose"):
        for got, want in zip(unwrap(getattr(lie, fn)(*ours)), unwrap(getattr(jt.lie, fn)(*theirs))):
            np.testing.assert_allclose(got, want, **TOL)
    for fn in ("transform", "untransform", "jtransform", "juntransform"):
        got = unwrap(getattr(lie, fn)(ours[0], torch.as_tensor(p)))
        for g_, w_ in zip(got, unwrap(getattr(jt.lie, fn)(theirs[0], jnp.asarray(p)))):
            np.testing.assert_allclose(g_, w_, **TOL)
    assert lie.cast(ours[0], lie.by_name(group)) is ours[0]
    with pytest.raises(ValueError, match="ltype mismatch"):
        lie.as_lietensor(ours[0], lie.Point2)


def test_top_level_exports_match_jax():
    """Every name of this slice the JAX package exports at its top level
    and in `lie` is exported by the port too."""
    names = ["SE2", "SO2", "SO3", "Point2", "SE2Family", "SO2Family", "SO3Family", "Point2Family",
             "enable_lie_group_check", "no_lie_group_check", "set_lie_group_check_enabled", "compose",
             "between", "inverse", "log_map", "exp_map", "adjoint", "local", "retract", "as_variable",
             "set_global_params"] + [f"{r}_{g}" for r in ("rand", "randn")
                                     for g in ("so2", "se2", "so3", "se3", "point2", "point3", "vector")]
    for n in names:
        assert hasattr(jt, n) and hasattr(tt, n), n
    for n in jt.lie.__all__:
        assert hasattr(tt.lie, n), n
