"""The Objective surface of theseus_tpu_torch against the JAX package, on the CPU, in float64.

`erase` (with the dropping of variables, families and aux that no cost
still references), the size and lookup methods, `dim` (a cost family
counts all its members), `error` and `error_metric` at values or at the
defaults, `compile(vectorize=...)` with the JAX package's persisting
explicit False and one-time warning, `TheseusLayer(vectorize=False)`, and
`build_pgo_objective(robust_loss_cls=..., log_loss_radius=...)`. Values
agree to 1e-12, solves to 1e-10: the same float64 arithmetic, differing
only in rounding order.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils.examples.pose_graph import (
    build_pgo_objective as jbuild,
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch.core.compiled import compile_objective
from theseus_tpu_torch.utils.convert import problem_from_arrays
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values

VALUE_TOL = dict(rtol=1e-12, atol=1e-12)
SOLVE_TOL = dict(rtol=1e-10, atol=1e-10)


def _pgo(n, b, seed=0):
    gt, edges, meas, init = jsynthetic(n_poses=n, batch=b, seed=seed, dtype=jnp.float64)
    arrays = dict(gt=np.array(gt), edges=np.array(edges), measurements=np.array(meas),
                  init=np.array(init), prior_weight=10.0)
    return arrays, (gt, edges, meas, init)


def _registries(obj):
    return (sorted(obj.cost_functions), sorted(obj.optim_vars), sorted(obj.var_families),
            sorted(obj.aux_vars))


def _small(pkg, lib):
    """Two points, a prior on each (aux targets) and a difference between
    them whose weight is an aux variable; plus a Vector family with a cost
    family over it (dim counts every member)."""
    obj = pkg.Objective(dtype=torch.float64, device="cpu") if pkg is tt else pkg.Objective(dtype=jnp.float64)
    arr = (lambda a: np.asarray(a, np.float64)) if pkg is tt else (lambda a: jnp.asarray(a, jnp.float64))
    x = pkg.Vector(2, name="x")
    y = pkg.Vector(2, name="y")
    tx = pkg.Variable(arr([[1.0, 2.0]]), name="tx")
    ty = pkg.Variable(arr([[-1.0, 0.5]]), name="ty")
    w = pkg.ScaleCostWeight(pkg.Variable(arr([[3.0]]), name="w"))

    def unit(name):  # every aux named: auto names count globally, per package
        return pkg.ScaleCostWeight(pkg.Variable(arr([[1.0]]), name=name))

    obj.add(pkg.Difference(x, tx, unit("w_px"), name="px"))
    obj.add(pkg.Difference(y, ty, unit("w_py"), name="py"))
    obj.add(pkg.Between(x, y, pkg.Variable(arr([[0.5, 0.5]]), name="dxy"), cost_weight=w, name="xy"))
    fam = lib.VectorFamily(3, 4, name="zs", tensor=arr(np.zeros((4, 1, 3))))
    targets = pkg.Variable(arr(np.arange(12.0).reshape(4, 1, 3)), name="zt")
    obj.add(lib.CostFamily(pkg.Difference(fam[0], targets, unit("w_z")), [(fam, np.arange(4))], name="zcosts"))
    return obj


@pytest.fixture
def both():
    import theseus_tpu.core as jcore
    import theseus_tpu_torch.core as tcore
    return _small(tt, tcore), _small(jt, jcore)


def test_sizes_lookup_and_dim_match_jax(both):
    obj, jobj = both
    assert _registries(obj) == _registries(jobj)
    for m in ("size_cost_functions", "size_variables", "size_aux_vars", "dim"):
        assert getattr(obj, m)() == getattr(jobj, m)(), m
    assert obj.dim() == 2 + 2 + 2 + 4 * 3
    assert obj.has_cost_function("xy") and not obj.has_cost_function("nope")
    assert obj.get_cost_function("xy") is obj.cost_functions["xy"]
    assert obj.get_cost_function("nope") is None


@pytest.mark.parametrize("name", ["xy", "px", "zcosts"])
def test_erase_drops_what_no_cost_references(both, name):
    obj, jobj = both
    got = obj.erase(name)
    want = jobj.erase(name)
    assert got.name == want.name == name
    assert _registries(obj) == _registries(jobj)
    assert obj.dim() == jobj.dim()
    if name == "xy":  # the weight's and the measurement's aux went with it
        assert "w" not in obj.aux_vars and "dxy" not in obj.aux_vars and "x" in obj.optim_vars
    if name == "zcosts":
        assert "zs" not in obj.var_families
    with pytest.raises(KeyError):
        obj.erase(name)


def test_erase_then_solve_recompiles():
    arrays, _ = _pgo(6, 2)
    obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    assert obj.compile().total_dim == 6 + 7 * 6
    obj.erase("edge_6")  # a loop closure: every pose is still referenced
    assert obj.size_variables() == 6 and obj.compile().total_dim == 6 + 6 * 6
    assert obj.error(input_tensors=inputs).shape == (2, obj.dim())


def test_error_and_error_metric_match_jax():
    arrays, (gt, edges, meas, init) = _pgo(8, 3)
    jobj, _ = jbuild(8, edges, meas, gt[0], dtype=jnp.float64)
    obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    jvals = jobj.default_values(jpose_values(init))
    want_e = np.asarray(jobj.error(jvals))
    want_m = np.asarray(jobj.error_metric(jvals))
    assert want_e.shape == (3, obj.dim())
    # at explicit values, and at default_values(input_tensors)
    np.testing.assert_allclose(obj.error(values=obj.default_values(inputs)).numpy(), want_e, **VALUE_TOL)
    np.testing.assert_allclose(obj.error(input_tensors=inputs).numpy(), want_e, **VALUE_TOL)
    np.testing.assert_allclose(obj.error_metric(input_tensors=inputs).numpy(), want_m, **VALUE_TOL)
    np.testing.assert_allclose(obj.error_metric(values=obj.default_values(inputs)).numpy(),
                               0.5 * (want_e ** 2).sum(-1), **VALUE_TOL)


def test_compile_vectorize_persists_with_one_warning():
    """The JAX package's semantics (tests/core/test_compiled_schemas.py): an
    explicit vectorize=False is kept by later compile() calls, which warn
    once; an explicit True switches back."""
    arrays, _ = _pgo(6, 2)
    obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    e_vec = obj.error(input_tensors=inputs)
    co_vec = obj.compile()
    assert co_vec.vectorized and len(co_vec.buckets) == 2
    co_off = obj.compile(vectorize=False)
    assert not co_off.vectorized and len(co_off.buckets) == obj.size_cost_functions()
    assert all(bk.k == 1 for bk in co_off.buckets)
    with pytest.warns(UserWarning, match="vectorize=False"):
        assert obj.compile() is co_off
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert obj.compile() is co_off  # once only
    np.testing.assert_allclose(obj.error(input_tensors=inputs).numpy(), e_vec.numpy(), **VALUE_TOL)
    assert obj.compile(vectorize=True).vectorized
    assert obj.compile().vectorized
    # compile_objective itself
    assert len(compile_objective(obj, vectorize=False).buckets) == obj.size_cost_functions()


def test_layer_vectorize_false_compiles_per_cost():
    arrays, _ = _pgo(6, 2)
    obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=3, linearization="sparse"), vectorize=False)
    with pytest.warns(UserWarning, match="vectorize=False"):
        out, _ = layer.forward(inputs)
    assert not obj.compile().vectorized
    assert out["pose_5"].shape == (2, 3, 4)


def test_unvectorized_pgo_solve_matches_vectorized_and_jax():
    """PGO 64 poses x batch 16, LM with the sparse linearization: the
    vectorized solve, the unvectorized one (every Between bucket K = 1) and
    the JAX package's unvectorized solve agree to 1e-10."""
    n, b, iters = 64, 16, 8
    arrays, (gt, edges, meas, init) = _pgo(n, b)

    def port(vectorize):
        obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True,
                                                      linearization="sparse"), vectorize=vectorize)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            out, info = layer.forward(inputs)
        assert obj.compile().vectorized == vectorize
        return torch.stack([out[f"pose_{i}"] for i in range(n)]).numpy(), info.last_err.numpy()

    jobj, _ = jbuild(n, edges, meas, gt[0], dtype=jnp.float64)
    assert len(jobj.compile(vectorize=False).buckets) == n + 2
    jlayer = jt.TheseusLayer(jt.LevenbergMarquardt(jobj, max_iterations=iters, adaptive_damping=True,
                                                   linearization="sparse"), vectorize=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jout, jinfo = jlayer.forward(jpose_values(init))
    jposes = np.stack([np.asarray(jout[f"pose_{i}"]) for i in range(n)])

    vec, vec_err = port(True)
    off, off_err = port(False)
    np.testing.assert_allclose(off, vec, **SOLVE_TOL)
    np.testing.assert_allclose(off_err, vec_err, **SOLVE_TOL)
    np.testing.assert_allclose(off, jposes, **SOLVE_TOL)
    np.testing.assert_allclose(off_err, np.asarray(jinfo.last_err), **SOLVE_TOL)


@pytest.mark.parametrize("loss", ["HuberLoss", "WelschLoss"])
def test_robust_pgo_objective_matches_jax(loss):
    """build_pgo_objective(robust_loss_cls=..., log_loss_radius=...): the
    robust Between edges "redge_<k>" sharing the aux "log_loss_radius";
    equal errors (1e-12) and LM solves (1e-10)."""
    n, b = 10, 2
    arrays, (gt, edges, meas, init) = _pgo(n, b, seed=3)
    jobj, _ = jbuild(n, edges, meas, gt[0], dtype=jnp.float64,
                     robust_loss_cls=getattr(jt, loss), log_loss_radius=0.3)
    obj, _ = build_pgo_objective(n, edges, arrays["measurements"], arrays["gt"][0], dtype=torch.float64,
                                 device="cpu", robust_loss_cls=getattr(tt, loss), log_loss_radius=0.3)
    assert sorted(obj.cost_functions) == sorted(jobj.cost_functions)
    assert "redge_3" in obj.cost_functions and "log_loss_radius" in obj.aux_vars
    inputs = pose_values(torch.as_tensor(arrays["init"]))
    jvals = jobj.default_values(jpose_values(init))
    np.testing.assert_allclose(obj.error(input_tensors=inputs).numpy(), np.asarray(jobj.error(jvals)),
                               **VALUE_TOL)

    kw = dict(max_iterations=6, adaptive_damping=True)
    out, info = tt.TheseusLayer(tt.LevenbergMarquardt(obj, **kw)).forward(inputs)
    jout, jinfo = jt.TheseusLayer(jt.LevenbergMarquardt(jobj, **kw)).forward(jpose_values(init))
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), **SOLVE_TOL)
    for i in range(n):
        np.testing.assert_allclose(out[f"pose_{i}"].numpy(), np.asarray(jout[f"pose_{i}"]), **SOLVE_TOL)


def test_robust_pgo_radius_tensor_takes_gradient():
    arrays, _ = _pgo(6, 2, seed=1)
    radius = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    obj, _ = build_pgo_objective(6, [tuple(e) for e in arrays["edges"]], arrays["measurements"],
                                 arrays["gt"][0], dtype=torch.float64, device="cpu",
                                 robust_loss_cls=tt.HuberLoss, log_loss_radius=radius)
    m = obj.error_metric(input_tensors=pose_values(torch.as_tensor(arrays["init"]))).sum()
    (g,) = torch.autograd.grad(m, radius)
    assert torch.isfinite(g) and float(g) != 0.0
