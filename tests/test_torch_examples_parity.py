"""The in-script logic of examples_torch/ against the JAX examples' functions on the same arrays, on the CPU, in float64 (part 1).

The JAX example modules are loaded by path (examples/ has no package);
where a script's logic lives inside its main(), the JAX side is rebuilt
here from the JAX package's functions exactly as the script writes it,
with float64 objectives (the JAX scripts leave the dtype to the default,
float32). JAX's random draws are fed to the port's pure functions.

- pose_graph_cube at --n-per-edge 2: the trajectory (1e-12), and the ATE
  of the plain, Welsch and GNC solves (1e-8 relative);
- state_estimation_2d: the outer loss and its gradient with respect to
  the log GPS weight in each backward mode (1e-8 relative);
- backward_modes: the four gradients and the loss (1e-8 relative).

Part 2 is tests/test_torch_examples_parity2.py.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples_torch import backward_modes, pose_graph_cube, state_estimation_2d  # noqa: E402


def load_jax_example(name):
    """examples/<name>.py as a module (the scripts import examples/_config.py
    as `_config`, so examples/ is on sys.path while it loads)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return mod


def test_pose_graph_cube_matches_jax():
    jmod = load_jax_example("pose_graph_cube")
    f64, n_per_edge, frac, seed = jnp.float64, 2, 0.3, 0
    gt = jmod.cube_trajectory(n_per_edge, f64)
    np.testing.assert_allclose(pose_graph_cube.cube_trajectory(n_per_edge, torch.float64).numpy(), np.asarray(gt),
                               rtol=0, atol=1e-12)
    n = gt.shape[0]
    n_edges = len(pose_graph_cube.edges_of(n)[0])
    # the JAX script's draws: measurement noise from split(PRNGKey(seed), 3)[0], initialization from PRNGKey(99)
    meas_noise = jax.random.normal(jax.random.split(jax.random.PRNGKey(seed), 3)[0], (n_edges, 1, 6), dtype=f64)
    init_noise = jax.random.normal(jax.random.PRNGKey(99), (n, 1, 6), dtype=f64)
    init = jt.lie.se3.compose(gt, jt.lie.se3.exp(0.1 * init_noise))
    init_vals = {f"pose_{i}": init[i] for i in range(n)}
    want = {}
    for mode in pose_graph_cube.MODES:
        obj, _ = jmod.build_problem(gt, frac, seed, mode, f64)
        values, _ = jmod.solve(obj, gt, init_vals, gnc=(mode == "gnc"))
        want[mode] = jmod.ate(values, gt)
    got = pose_graph_cube.run(frac, n_per_edge, seed, noise=(torch.as_tensor(np.asarray(meas_noise)),
                                                              torch.as_tensor(np.asarray(init_noise))),
                              dtype=torch.float64, device="cpu", verbose=False)
    for mode in pose_graph_cube.MODES:
        np.testing.assert_allclose(got[mode], want[mode], rtol=1e-8)
    assert got["welsch"] < 0.8 * got["none"] and got["gnc"] < 0.8 * got["none"]


@pytest.mark.parametrize("mode", state_estimation_2d.MODES)
def test_state_estimation_2d_gradient_matches_jax(mode):
    jmod = load_jax_example("state_estimation_2d")
    steps, batch = 20, 8
    gt, gps, odo = jmod.simulate(batch, steps)
    w = jt.ScaleCostWeight(jnp.asarray(1.0, jnp.float64), name="gps_weight")
    obj, _ = jmod.build(steps, gps, odo, w)
    opt = jt.GaussNewton(obj, max_iterations=10)
    layer = jt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values({f"x_{i}": jnp.zeros((batch, 2), jnp.float64) for i in range(steps)})
    state = co.pack(values, batch)
    gt_flat = gt.reshape(batch, -1)

    def loss_fn(log_w):  # the JAX script's
        vals = dict(values)
        vals[w.scale.name] = jnp.exp(log_w) * jnp.ones((1, 1))
        carry = layer.solve_state(state, co.build_aux(vals, batch), mode, opt.opts, 5)
        sol = co.unpack(carry["state"])
        est = jnp.concatenate([sol[f"x_{i}"] for i in range(steps)], axis=-1)
        return jnp.mean((est - gt_flat) ** 2)

    want, want_g = jax.jit(jax.value_and_grad(loss_fn))(jnp.asarray(0.3, jnp.float64))
    log_w = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    loss = state_estimation_2d.make_loss(mode, batch, steps, device="cpu")(log_w)
    (g,) = torch.autograd.grad(loss, [log_w])
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-8)
    np.testing.assert_allclose(float(g), float(want_g), rtol=1e-8)
    assert float(g) != 0.0


def test_backward_modes_match_jax():
    rng = np.random.RandomState(0)
    batch, npts = 2, 25
    x = jnp.asarray(rng.uniform(-1, 1, (batch, npts)))
    ab_true = jnp.asarray(rng.uniform(0.5, 2.0, (batch, 2)))
    y = ab_true[:, :1] * x ** 2 + ab_true[:, 1:]
    ab = jt.Vector(2, name="ab")
    xv, yv = jt.Variable(x, name="x"), jt.Variable(y, name="y")

    def err_fn(optim, aux):
        (ab,) = optim
        xx, yy = aux
        return yy - (ab[0] * xx ** 2 + ab[1])

    obj = jt.Objective(dtype=jnp.float64)
    obj.add(jt.AutoDiffCostFunction([ab], npts, err_fn, aux_vars=[xv, yv]))
    opt = jt.GaussNewton(obj, max_iterations=12)
    layer = jt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values({"ab": jnp.zeros((batch, 2))})
    state = co.pack(values, batch)

    def make_loss(mode):  # the JAX script's
        def f(theta):
            vals = dict(values)
            vals["y"] = theta * y
            carry = layer.solve_state(state, co.build_aux(vals, batch), mode, opt.opts, 4)
            return jnp.sum(co.unpack(carry["state"])["ab"] ** 2)
        return f

    theta = jnp.asarray(1.17, jnp.float64)
    _, loss = backward_modes.problem(dtype=torch.float64, device="cpu")
    got = backward_modes.gradients(loss, 1.17, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(float(loss("implicit", torch.tensor(1.17, dtype=torch.float64))),
                               float(make_loss("implicit")(theta)), rtol=1e-8)
    for mode in backward_modes.MODES:
        want = jax.jit(jax.grad(make_loss(mode)))(theta)
        np.testing.assert_allclose(float(got[mode]), float(want), rtol=1e-8, err_msg=mode)
    # the modes agree with the central difference (the script's reference)
    np.testing.assert_allclose(float(got["implicit"]), float(got["fd"]), rtol=1e-4)
