"""The 2-D pose-graph path of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `read_2d_g2o` on tests/fixtures/mini_2d.g2o against the JAX reader
  (1e-12) and the hand-computed values of tests/optim/test_g2o_format.py;
  a line with missing fields raises; without a device named it needs the
  card;
- the fixture's vertices agree exactly with its edges: moved off them by
  a fixed tangent (MINI_2D_SHIFT), the graph is solved back to zero error
  (< 1e-10) on the dense and sparse linearizations;
- a Manhattan graph of scripts/manhattan_g2o.py (100 poses, seed 0)
  solved by both packages through `TheseusLayer.forward` (SE2 variables,
  a Between per edge with the uniform DiagonalCostWeight, a Local prior on
  pose 0 with weight 10; LM with adaptive damping, 30 iterations) on the
  sparse and dense linearizations: final error to 1e-10 relative;
- the 500-pose graph of the committed JAX golden
  (tests/fixtures/pgo2d_500_jax_f64.npz, scripts/make_pgo2d_golden.py),
  regenerated from its seed and solved by the port on the sparse level
  plan: final error and poses to 1e-8;
- examples/state_estimation_2d.py's Point2 problem (20 steps, batch 8,
  Gauss-Newton): the outer gradient of the log GPS weight in the four
  backward modes against `jax.grad` of the JAX layer, to 1e-8 as
  tests/test_torch_dense.py holds its curve fit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils.examples.pose_graph import read_2d_g2o as jread_2d_g2o
import theseus_tpu_torch as tt
from theseus_tpu_torch.utils.examples.pose_graph import read_2d_g2o

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "mini_2d.g2o"
GOLDEN = ROOT / "tests" / "fixtures" / "pgo2d_500_jax_f64.npz"
ITERS = 30


def _manhattan():
    spec = importlib.util.spec_from_file_location("manhattan_g2o", ROOT / "scripts" / "manhattan_g2o.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_read_2d_g2o_matches_jax_reader():
    n, poses, edges, meas, w = read_2d_g2o(FIXTURE, device="cpu")
    jn, jposes, jedges, jmeas, jw = jread_2d_g2o(str(FIXTURE))
    assert (n, edges) == (jn, jedges) == (3, [(0, 1), (1, 2)])
    for got, want in ((poses, jposes), (meas, jmeas), (w, jw)):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64 and got.device.type == "cpu"
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_read_2d_g2o_contract():
    _, poses, _, meas, w = read_2d_g2o(FIXTURE, dtype=torch.float32, device="cpu")
    assert poses.dtype == meas.dtype == w.dtype == torch.float32
    assert tuple(poses.shape) == (3, 1, 4) and tuple(meas.shape) == (2, 1, 4) and tuple(w.shape) == (2, 3, 3)
    poses, meas, w = poses[:, 0].double().numpy(), meas[:, 0].double().numpy(), w.double().numpy()
    np.testing.assert_allclose(poses[0], [0, 0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(poses[1], [1, 0, 0, 1], atol=1e-6)  # theta = pi/2
    np.testing.assert_allclose(poses[2], [1, 2, -1, 0], atol=1e-6)  # theta = pi
    np.testing.assert_allclose(meas[0], [1, 0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(meas[1], [2, 0, 0, 1], atol=1e-6)
    info0 = np.array([[4.0, 1, 0], [1, 4, 0], [0, 0, 1]])
    np.testing.assert_allclose(w[0].T @ w[0], info0, atol=1e-5)
    np.testing.assert_allclose(w[1].T @ w[1], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(w[0], np.triu(w[0]), atol=0)


def test_read_2d_g2o_runs_on_the_card_by_default(monkeypatch):
    """device None is the card: without one the reader raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        read_2d_g2o(FIXTURE)


@pytest.mark.parametrize("line", ["VERTEX_SE2 0 0 0\n", "EDGE_SE2 0 1 1 0 0 1 0 0 1 0\n"],
                         ids=["vertex", "edge"])
def test_read_2d_g2o_rejects_missing_tokens(tmp_path, line):
    bad = tmp_path / "bad.g2o"
    bad.write_text("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\n" + line)
    with pytest.raises(ValueError):
        read_2d_g2o(bad, device="cpu")


def _objective(pkg, n, edges, meas, w, prior, **okw):
    """SE2 poses, a Between per edge weighted by the uniform
    sqrt-information's diagonal, a Local prior on pose 0 (weight 10)."""
    w = np.asarray(w[0])
    obj = pkg.Objective(**okw)
    poses = [pkg.SE2(name=f"pose_{i}") for i in range(n)]
    obj.add(pkg.Local(poses[0], np.asarray(prior), pkg.ScaleCostWeight(10.0), name="prior"))
    weight = pkg.DiagonalCostWeight(np.sqrt(np.diag(w.T @ w))[None])
    meas = np.asarray(meas)
    for e, (i, j) in enumerate(edges):
        obj.add(pkg.Between(poses[i], poses[j], meas[e], cost_weight=weight, name=f"edge_{e}"))
    return obj


def _port_solve(path, linearization, iters=ITERS, shift=None):
    n, poses, edges, meas, w = read_2d_g2o(path, device="cpu")
    if shift is not None:
        poses = torch.cat([poses[:1], tt.lie.SE2.retract(poses[1:], torch.as_tensor(shift))])
    obj = _objective(tt, n, edges, meas, w, poses[0], dtype=torch.float64, device="cpu")
    opt = tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization=linearization)
    out, info = tt.TheseusLayer(opt).forward({f"pose_{i}": poses[i] for i in range(n)})
    return opt, out, info


MINI_2D_SHIFT = [0.1, -0.05, 0.05]


@pytest.mark.parametrize("linearization", ["dense", "sparse"])
def test_mini_2d_solves_to_zero(linearization):
    _, _, info = _port_solve(FIXTURE, linearization, iters=15, shift=MINI_2D_SHIFT)
    assert float(info.err_history[0, 0]) > 1e-3
    assert float(info.last_err[0]) < 1e-10


@pytest.mark.parametrize("linearization", ["sparse", "dense"])
def test_manhattan_graph_matches_jax(tmp_path, linearization):
    mg = _manhattan()
    path = tmp_path / "m100.g2o"
    graph = mg.generate(100, 0)
    mg.write_g2o(path, graph)
    assert len(graph["edges"]) == 99 + round(100 * mg.M3500_LOOP_CLOSURES / mg.M3500_POSES)
    opt, out, info = _port_solve(path, linearization)
    if linearization == "sparse":
        assert opt.normal_builder.pattern.d == 3  # SE2 blocks
    jn, jposes, jedges, jmeas, jw = jread_2d_g2o(str(path))
    jobj = _objective(jt, jn, jedges, jmeas, jw, jposes[0], dtype=jnp.float64)
    jopt = jt.LevenbergMarquardt(jobj, max_iterations=ITERS, adaptive_damping=True, linearization=linearization)
    jout, jinfo = jt.TheseusLayer(jopt).forward({f"pose_{i}": jposes[i] for i in range(jn)})
    assert float(info.err_history[0, 0]) > 10 * float(info.last_err[0])
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=1e-10, atol=0)
    for i in range(0, jn, 7):
        np.testing.assert_allclose(out[f"pose_{i}"].numpy(), np.asarray(jout[f"pose_{i}"]), atol=1e-8)


def test_port_matches_the_committed_jax_golden(tmp_path):
    golden = np.load(GOLDEN)
    n, seed = int(golden["n_poses"]), int(golden["seed"])
    assert int(golden["iters"]) == ITERS
    mg = _manhattan()
    path = tmp_path / "golden.g2o"
    mg.write_g2o(path, mg.generate(n, seed))
    opt, out, info = _port_solve(path, "sparse")
    sched = opt.normal_builder.sched
    assert opt.normal_builder.pattern.d == 3
    assert sched.tail_k > 0 and len(sched.level_tables) > 1  # a head of levels and a dense tail
    np.testing.assert_allclose(info.last_err.numpy(), golden["last_err"], rtol=1e-8, atol=0)
    poses = np.stack([out[f"pose_{i}"][0].numpy() for i in range(n)])
    np.testing.assert_allclose(poses, golden["poses"], atol=1e-8)


# ---------------------------------------------------------------------------
# examples/state_estimation_2d.py: Point2 chain, learned GPS weight
# ---------------------------------------------------------------------------
STEPS, BATCH = 20, 8


def _simulate(seed=0):
    rng = np.random.RandomState(seed)
    vel = rng.uniform(-0.3, 0.3, (BATCH, 1, 2))
    gt = np.cumsum(np.repeat(vel, STEPS, axis=1), axis=1)
    gps = gt + 0.4 * rng.randn(*gt.shape)
    odo = np.diff(gt, axis=1) + 0.05 * rng.randn(BATCH, STEPS - 1, 2)
    return gt, gps, odo


def _state_objective(pkg, gps, odo, **okw):
    obj = pkg.Objective(**okw)
    xs = [pkg.Point2(name=f"x_{i}") for i in range(STEPS)]
    w = pkg.ScaleCostWeight(np.ones((1, 1)), name="gps_weight")
    for i in range(STEPS):
        obj.add(pkg.Local(xs[i], gps[:, i], w, name=f"gps_{i}"))
    ow = pkg.ScaleCostWeight(10.0)
    for i in range(STEPS - 1):
        obj.add(pkg.Between(xs[i], xs[i + 1], odo[:, i], cost_weight=ow, name=f"odo_{i}"))
    return obj, w.scale.name


def _jax_state_grad(mode, gt, gps, odo):
    obj, wname = _state_objective(jt, jnp.asarray(gps), jnp.asarray(odo), dtype=jnp.float64)
    opt = jt.GaussNewton(obj, max_iterations=10)
    layer, co = jt.TheseusLayer(opt), obj.compile()
    values = obj.default_values({f"x_{i}": jnp.zeros((BATCH, 2), jnp.float64) for i in range(STEPS)})
    state = co.pack(values, BATCH)

    def loss(log_w):
        vals = dict(values)
        vals[wname] = jnp.exp(log_w) * jnp.ones((1, 1))
        carry = layer.solve_state(state, co.build_aux(vals, BATCH), mode, opt.opts, 5)
        sol = co.unpack(carry["state"])
        est = jnp.concatenate([sol[f"x_{i}"] for i in range(STEPS)], axis=-1)
        return jnp.mean((est - jnp.asarray(gt).reshape(BATCH, -1)) ** 2)

    return float(jax.jit(jax.grad(loss))(jnp.asarray(0.0, jnp.float64)))


@pytest.mark.parametrize("mode", ["unroll", "implicit", "truncated", "dlm"])
def test_state_estimation_2d_gradient_matches_jax(mode):
    gt, gps, odo = _simulate()
    obj, wname = _state_objective(tt, gps, odo, dtype=torch.float64, device="cpu")
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=10))
    log_w = torch.zeros((), dtype=torch.float64, requires_grad=True)
    inputs = {f"x_{i}": torch.zeros(BATCH, 2, dtype=torch.float64) for i in range(STEPS)}
    inputs[wname] = torch.exp(log_w).reshape(1, 1)
    out, _ = layer.forward(inputs, optimizer_kwargs={"backward_mode": mode, "backward_num_iterations": 5})
    est = torch.cat([out[f"x_{i}"] for i in range(STEPS)], dim=-1)
    loss = torch.mean((est - torch.as_tensor(gt).reshape(BATCH, -1)) ** 2)
    (g,) = torch.autograd.grad(loss, log_w)
    want = _jax_state_grad(mode, gt, gps, odo)
    assert np.isfinite(float(g)) and abs(float(g)) > 1e-4
    np.testing.assert_allclose(float(g), want, rtol=1e-8)
