"""The rest of the optimizer surface of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `Dogleg` on the dense, sparse and Schur linearizations: a PGO chain
  (16 poses x batch 3, the JAX package's synthetic graph carried across by
  utils/convert.py) and a small bundle adjustment (5 cameras, 24 points,
  batch 2, landmark 0 pinned): final error, error history and solution
  against JAX's Dogleg, 1e-8. The Schur system's quadratic form (which
  Dogleg reads) against JAX's `SchurNormal.quad` on the same AtA, 1e-10.
- `LinearOptimizer`: one iteration solves a linear least-squares problem,
  as JAX's does (1e-10).
- `optimize()`: values and info against JAX's optimize (1e-8); a second
  call on the same objective reuses the normal builder and runs no second
  symbolic analysis.
- `track_state_history`: the JAX package's `test_track_state_history` case,
  and the whole history against JAX's (NaN where JAX has NaN).
- `end_iter_callback`: called once an iteration with device tensors; the
  per-iteration err equals JAX's (1e-10).
- `verbose`: one line an iteration run, from optimize() and from the
  layer.
- the layer's `supported_modes` check raises for a mode the optimizer
  does not support.
- `VariableOrdering`: the cases of tests/optim/test_ordering.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.optim.ordering import VariableOrdering as JVariableOrdering
from theseus_tpu.optim.schur import SchurNormalBuilder as JSchurBuilder
from theseus_tpu.optim.schur import eliminate_points as jeliminate
from theseus_tpu.utils.examples.bundle_adjustment import (
    ba_values as jba_values,
    build_ba_objective as jbuild_ba,
    synthetic_ba as jsynthetic_ba,
)
from theseus_tpu.utils.examples.pose_graph import (
    build_pgo_objective as jbuild_pgo,
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic_pgo,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch.optim import ordering as ordering_mod
from theseus_tpu_torch.optim.ordering import VariableOrdering, resolve_ordering
from theseus_tpu_torch.optim.schur import SchurNormal, SchurNormalBuilder, eliminate_points
from theseus_tpu_torch.utils.convert import ba_problem_from_arrays, problem_from_arrays
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective

N, B, ITERS = 16, 3, 10
TOL = 1e-8


@functools.lru_cache(maxsize=None)
def _pgo():
    gt, edges, meas, init = jsynthetic_pgo(n_poses=N, batch=B, seed=1, dtype=jnp.float64)
    arrays = dict(gt=np.array(gt), edges=np.array(edges), measurements=np.array(meas), init=np.array(init),
                  prior_weight=10.0)
    return arrays, (gt, edges, meas, init)


def _pgo_pair(lin, jcls, tcls, **kw):
    arrays, (gt, edges, meas, init) = _pgo()
    jobj, _ = jbuild_pgo(N, edges, meas, gt[0], dtype=jnp.float64)
    obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    return ((jcls(jobj, max_iterations=ITERS, linearization=lin, **kw), jpose_values(init)),
            (tcls(obj, max_iterations=ITERS, linearization=lin, **kw), inputs))


@functools.lru_cache(maxsize=None)
def _ba_arrays():
    jp = jsynthetic_ba(num_cameras=5, num_points=24, batch=2, seed=0, visibility=0.6, dtype=jnp.float64)
    keys = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img", "gt_poses", "gt_points")
    return jp, {k: np.asarray(getattr(jp, k)) for k in keys}


def _ba_pair(lin, jcls, tcls, **kw):
    jp, arrays = _ba_arrays()
    jobj, _, jpts = jbuild_ba(jp, gauge_target=jp.gt_poses[0])
    jobj.add(jt.Local(jpts[0], jp.gt_points[0], jt.ScaleCostWeight(jnp.asarray(10.0, jnp.float64)), name="pin"))
    prob = ba_problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    obj, _, pts = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0])
    obj.add(tt.Local(pts[0], prob.gt_points[0].numpy(), tt.ScaleCostWeight(10.0), name="pin"))
    return ((jcls(jobj, max_iterations=ITERS, linearization=lin, **kw), jba_values(jp)),
            (tcls(obj, max_iterations=ITERS, linearization=lin, **kw), ba_values(prob)))


def _assert_same_solve(jpair, tpair):
    (jopt, jin), (opt, tin) = jpair, tpair
    jout, jinfo = jt.TheseusLayer(jopt).forward(jin)
    out, info = tt.TheseusLayer(opt).forward(tin)
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=TOL)
    np.testing.assert_allclose(info.err_history.numpy(), np.asarray(jinfo.err_history), rtol=TOL)
    for k, v in out.items():
        if k in jout and isinstance(v, torch.Tensor) and v.dtype == torch.float64:
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]), rtol=TOL, atol=TOL)
    return info


@pytest.mark.parametrize("lin", ["dense", "sparse"])
def test_dogleg_pgo_matches_jax(lin):
    info = _assert_same_solve(*_pgo_pair(lin, jt.Dogleg, tt.Dogleg))
    assert float(info.last_err.max()) < float(info.err_history[0].min())


@pytest.mark.parametrize("lin", ["schur", "dense"])
def test_dogleg_ba_matches_jax(lin):
    info = _assert_same_solve(*_ba_pair(lin, jt.Dogleg, tt.Dogleg))
    assert float(info.last_err.max()) < float(info.err_history[0].min())


def test_schur_quad_matches_jax():
    (jopt, jin), (opt, tin) = _ba_pair("schur", jt.Dogleg, tt.Dogleg)
    jco, co = jopt.objective.compile(), opt.objective.compile()
    jvals = jopt.objective.default_values(jin)
    b = jco.resolve_batch_size(jvals)
    jns = JSchurBuilder(jco, jeliminate).build(jco.pack(jvals, b), jco.build_aux(jvals, b))
    ns = SchurNormal(SchurNormalBuilder(co, eliminate_points), torch.as_tensor(np.array(jns.ata)),
                     torch.as_tensor(np.array(jns.atb_blocks)))
    v = np.random.default_rng(0).standard_normal(tuple(ns.Atb.shape))
    want = np.asarray(jns.quad(jnp.asarray(v)))
    np.testing.assert_allclose(ns.quad(torch.as_tensor(v)).numpy(), want, rtol=1e-10)


def _quad_pair(batch=3, dim=4, seed=0):
    """A linear least-squares objective x - target in both packages."""
    rng = np.random.RandomState(seed)
    target = rng.uniform(-1, 1, size=(batch, dim))

    def err_fn(optim, aux):
        return optim[0] - aux[0]

    out = []
    for m, kw in ((jt, dict(dtype=jnp.float64)), (tt, dict(dtype=torch.float64, device="cpu"))):
        obj = m.Objective(**kw)
        obj.add(m.AutoDiffCostFunction([m.Vector(dim, name="x")], dim, err_fn,
                                       aux_vars=[m.Variable(target, name="target")], name="q"))
        out.append(obj)
    return out, target


@pytest.mark.parametrize("lin", ["dense", "sparse"])
def test_linear_optimizer_one_step(lin):
    (jobj, obj), target = _quad_pair()
    x0 = np.zeros_like(target)
    jvals, jinfo = jt.LinearOptimizer(jobj, linearization=lin).optimize(input_tensors={"x": jnp.asarray(x0)})
    opt = tt.LinearOptimizer(obj, linearization=lin)
    assert opt.opts.max_iterations == 1
    vals, info = opt.optimize(input_tensors={"x": torch.as_tensor(x0)})
    np.testing.assert_allclose(vals["x"].numpy(), target, atol=1e-10)
    np.testing.assert_allclose(vals["x"].numpy(), np.asarray(jvals["x"]), atol=1e-10)
    assert info.err_history.shape == (2, 3)


def test_optimize_matches_jax_and_reuses_the_symbolic_analysis(monkeypatch):
    (jopt, jin), (opt, tin) = _pgo_pair("sparse", jt.LevenbergMarquardt, tt.LevenbergMarquardt,
                                        adaptive_damping=True)
    jvals, jinfo = jopt.optimize(input_tensors=jin)
    calls = []
    real = ordering_mod.symbolic_for
    monkeypatch.setattr("theseus_tpu_torch.optim.normal.symbolic_for",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    vals, info = opt.optimize(input_tensors=tin)
    builder = opt.normal_builder
    vals2, info2 = opt.optimize(input_tensors=tin)
    assert len(calls) == 1 and opt.normal_builder is builder
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=TOL)
    np.testing.assert_array_equal(info.status.numpy(), np.asarray(jinfo.status))
    np.testing.assert_array_equal(info2.last_err.numpy(), info.last_err.numpy())
    for i in range(N):
        np.testing.assert_allclose(vals[f"pose_{i}"].numpy(), np.asarray(jvals[f"pose_{i}"]), atol=TOL)
    assert not vals["pose_1"].requires_grad


def test_track_state_history():
    (jobj, obj), target = _quad_pair()
    x0 = np.zeros_like(target)
    jinfo = jt.GaussNewton(jobj, max_iterations=4, track_state_history=True).optimize(
        input_tensors={"x": jnp.asarray(x0)})[1]
    info = tt.GaussNewton(obj, max_iterations=4, track_state_history=True).optimize(
        input_tensors={"x": torch.as_tensor(x0)})[1]
    assert info.state_history is not None
    hist = info.state_history["Rn4"].numpy()  # (iters + 1, N, B, dim)
    assert hist.shape == (5, 1, 3, 4)
    np.testing.assert_allclose(hist[0, 0], x0, atol=0)
    # GN on a linear problem converges in one step; iteration 1 = solution
    np.testing.assert_allclose(hist[1, 0], target, atol=1e-9)
    np.testing.assert_allclose(hist, np.asarray(jinfo.state_history["Rn4"]), atol=1e-12)
    assert tt.GaussNewton(obj, max_iterations=4).optimize(input_tensors={"x": torch.as_tensor(x0)})[1] \
        .state_history is None


def test_track_state_history_pgo_matches_jax():
    (jopt, jin), (opt, tin) = _pgo_pair("dense", jt.LevenbergMarquardt, tt.LevenbergMarquardt,
                                        track_state_history=True)
    jinfo = jopt.optimize(input_tensors=jin)[1]
    info = opt.optimize(input_tensors=tin)[1]
    got, want = info.state_history["SE3"].numpy(), np.asarray(jinfo.state_history["SE3"])
    assert got.shape == (ITERS + 1, N, B, 3, 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_end_iter_callback_matches_jax():
    jerrs, calls = [], []
    (jopt, jin), (opt, tin) = _pgo_pair(
        "sparse", jt.LevenbergMarquardt, tt.LevenbergMarquardt, adaptive_damping=True)
    jopt.end_iter_callback = lambda o, e, d, i: jerrs.append((i, np.asarray(e)))
    opt.end_iter_callback = lambda o, e, d, i: calls.append((o, e, d, i))
    jopt.optimize(input_tensors=jin)
    _, info = opt.optimize(input_tensors=tin)
    assert len(calls) == len(jerrs) > 0
    for (o, e, d, i), (ji, je) in zip(calls, jerrs):
        assert o is opt and isinstance(i, int) and i == ji
        assert isinstance(e, torch.Tensor) and tuple(d.shape) == (B, 6 * N)
        np.testing.assert_allclose(e.numpy(), je, rtol=1e-10)
    # passed as a keyword, as in the JAX package
    obj = opt.objective
    cb_opt = tt.GaussNewton(obj, max_iterations=2, linearization="sparse", end_iter_callback=lambda *a: None)
    assert cb_opt.end_iter_callback is not None


def test_verbose_prints_each_iteration(capsys):
    (_, obj), target = _quad_pair()
    x0 = torch.zeros(tuple(target.shape), dtype=torch.float64)
    opt = tt.LevenbergMarquardt(obj, max_iterations=3)
    _, info = opt.optimize(input_tensors={"x": x0}, verbose=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Nonlinear optimizer")]
    ran = int(torch.isfinite(info.err_history).all(dim=1).sum()) - 1  # optimize() stops early
    assert len(lines) == ran >= 1 and lines[0].startswith("Nonlinear optimizer. Iteration: 1. Error: ")
    assert float(lines[-1].split("Error: ")[1]) == pytest.approx(float(info.last_err.mean()), rel=1e-12)
    tt.TheseusLayer(opt).forward({"x": x0}, optimizer_kwargs={"verbose": True})  # unroll: all 3
    assert sum(ln.startswith("Nonlinear optimizer") for ln in capsys.readouterr().out.splitlines()) == 3
    opt.optimize(input_tensors={"x": x0})
    assert capsys.readouterr().out == ""


def test_supported_modes_error():
    (_, obj), target = _quad_pair()

    class UnrollOnly(tt.GaussNewton):
        supported_modes = ("unroll",)

    layer = tt.TheseusLayer(UnrollOnly(obj, max_iterations=3))
    x0 = torch.zeros(tuple(target.shape), dtype=torch.float64)
    layer.forward({"x": x0})
    with pytest.raises(ValueError, match="supports backward modes"):
        layer.forward({"x": x0}, optimizer_kwargs={"backward_mode": "implicit"})
    assert tt.Dogleg.supported_modes == ("unroll", "implicit", "truncated", "dlm")


def _ordering_objective(m, **kw):
    x = m.Vector(tensor=np.zeros((1, 2)), name="x")
    y = m.Vector(tensor=np.zeros((1, 2)), name="y")
    t = m.Vector(tensor=np.ones((1, 2)), name="t")
    w = m.ScaleCostWeight(1.0)
    obj = m.Objective(**kw)
    obj.add(m.Local(x, t, w, name="cx"))
    obj.add(m.Local(y, t, w, name="cy"))
    obj.add(m.Between(x, y, m.Vector(tensor=np.ones((1, 2)), name="m"), w, name="cxy"))
    return obj


def test_variable_ordering_api():
    obj = _ordering_objective(tt, dtype=torch.float64, device="cpu")
    vo = VariableOrdering(obj)
    assert vo.names() == ["x", "y"]
    assert vo.complete
    assert vo.index_of("y") == 1
    with pytest.raises(ValueError):
        vo.append("x")  # duplicate
    with pytest.raises(ValueError):
        vo.append("nope")  # not in objective
    custom = VariableOrdering(obj, default_order=False)
    custom.extend(["y", "x"])
    assert custom.as_permutation(["x", "y"]).tolist() == [1, 0]
    assert not VariableOrdering(obj, default_order=False).complete

    # the solver takes the ordering object and reaches the same solution
    sol, _ = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=10, linearization="sparse",
                                                   ordering=custom)).forward()
    sol2, _ = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=10, linearization="sparse",
                                                    ordering="nd")).forward()
    jsol, _ = jt.TheseusLayer(jt.LevenbergMarquardt(_ordering_objective(jt, dtype=jnp.float64), max_iterations=10,
                                                    linearization="sparse",
                                                    ordering=JVariableOrdering(names=["y", "x"]))).forward()
    for k in ("x", "y"):
        np.testing.assert_allclose(sol[k].numpy(), sol2[k].numpy(), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(sol[k].numpy(), np.asarray(jsol[k]), rtol=1e-8, atol=1e-8)


def test_explicit_permutation_matches_dense():
    arrays, _ = _pgo()
    perm = np.arange(N)[::-1].copy()
    sols = {}
    for name, kw in (("perm", dict(linearization="sparse", ordering=perm)),
                     ("names", dict(linearization="sparse", ordering=[f"pose_{i}" for i in perm])),
                     ("dense", dict(linearization="dense"))):
        obj, inputs = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
        opt = tt.GaussNewton(obj, max_iterations=5, **kw)
        sols[name] = opt.optimize(input_tensors=inputs)[1].last_err.numpy()
        if name != "dense":
            assert np.array_equal(opt.normal_builder.sched.perm, perm)
    np.testing.assert_allclose(sols["perm"], sols["dense"], rtol=1e-8)
    np.testing.assert_array_equal(sols["perm"], sols["names"])


def test_resolve_ordering_specs():
    assert resolve_ordering("amd", ["a", "b"]) == "amd"
    assert resolve_ordering(["b", "a"], ["a", "b"]).tolist() == [1, 0]
    assert resolve_ordering(VariableOrdering(names=["b", "a"]), ["a", "b"]).tolist() == [1, 0]
    with pytest.raises(ValueError):
        resolve_ordering(["b"], ["a", "b"])
    with pytest.raises(ValueError):
        resolve_ordering(["a", "c"], ["a", "b"])
