"""The in-script logic of examples_torch/ against the JAX examples' functions on the same arrays, on the CPU, in float64 (part 2).

As in tests/test_torch_examples_parity.py:

- se2_inverse: the fit from JAX's draws of x1 and x2: the final loss of
  50 iterations of tangent-space Adam (optax against torch.optim) and of 5
  of manifold SGD (1e-8 relative). SGD at the script's step 0.2 does not
  descend from this draw (its loss bounces between 24 and 153) and
  amplifies rounding about tenfold an iteration: the packages part by
  1e-13 after 5 iterations and by 3.8x after 30;
- se2_planning: the planned poses and velocities (1e-8);
- gbp_pose_graph at the smoke test's size (6 poses, 25 sweeps, 8 outer
  iterations): GBP's solution (1e-8), the final errors of GBP and GN
  (1e-8 absolute: both sit at ~1e-14) and the marginal translation
  standard deviations (1e-8 relative);
- motion_planning_learned: one outer step on JAX's problem draws at batch
  2 with JAX's model weights: the loss (1e-8 relative) and the gradient of
  every weight (1e-8 of its largest entry). The initial-trajectory model's
  gradient is exactly zero in both packages: the truncated backward runs
  its one differentiated iteration from the detached state of the no-grad
  prefix, so only the collision-weight model learns; its gradient is
  nonzero.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import theseus_tpu as jt
from theseus_tpu.lie import SE2 as JSE2
from theseus_tpu.lie import se2 as jse2

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from examples_torch import gbp_pose_graph, motion_planning_learned, se2_inverse, se2_planning  # noqa: E402
from test_torch_examples_parity import load_jax_example  # noqa: E402
from theseus_tpu_torch.utils.convert import mlp_from_params  # noqa: E402
from theseus_tpu_torch.utils.examples.motion_planning import (CollisionWeightModel,  # noqa: E402
                                                              InitialTrajectoryModel)


def test_se2_inverse_fit_matches_jax():
    jmod = load_jax_example("se2_inverse")
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    x1 = JSE2.randn(k1, 1, dtype=jnp.float64)
    x2 = JSE2.randn(k2, 1, dtype=jnp.float64)
    t1, t2 = torch.as_tensor(np.asarray(x1)), torch.as_tensor(np.asarray(x2))
    for lie_tangent, iters in ((True, 50), (False, 5)):
        want = jmod.run(num_iters=iters, use_lie_tangent=lie_tangent, seed=0)
        got, _ = se2_inverse.run(t1, t2, num_iters=iters, use_lie_tangent=lie_tangent, verbose=False)
        np.testing.assert_allclose(got, want, rtol=1e-8)
    assert se2_inverse.run(t1, t2, num_iters=50, verbose=False)[0] < float(se2_inverse.loss_fn(t1, t2))


def test_se2_planning_matches_jax():
    # the JAX script's main(), float64, as written there
    n, dt, iters, nh_w = 16, 0.25, 80, 50.0
    dtype = jnp.float64
    obj = jt.Objective(dtype=dtype)
    poses = [jt.SE2(name=f"pose_{i}") for i in range(n)]
    vels = [jt.Vector(3, name=f"vel_{i}") for i in range(n)]
    start = jnp.asarray([[0.0, 0.0, 1.0, 0.0]], dtype)
    goal = jnp.asarray([[2.0, 1.0, 0.0, 1.0]], dtype)
    bw = jt.ScaleCostWeight(jnp.asarray(100.0, dtype))
    obj.add(jt.Local(poses[0], start, bw, name="start"))
    obj.add(jt.Local(poses[-1], goal, bw, name="goal"))
    obj.add(jt.Local(vels[0], jnp.zeros((1, 3), dtype), bw, name="v0"))
    obj.add(jt.Local(vels[-1], jnp.zeros((1, 3), dtype), bw, name="vT"))
    dw = jt.ScaleCostWeight(jnp.asarray(5.0, dtype))
    nw = jt.ScaleCostWeight(jnp.asarray(nh_w, dtype))
    for i in range(n - 1):
        obj.add(jt.DoubleIntegrator(poses[i], vels[i], poses[i + 1], vels[i + 1], dt, dw, name=f"di_{i}"))
    for i in range(n):
        obj.add(jt.Nonholonomic(poses[i], vels[i], nw, name=f"nh_{i}"))
    init = {f"pose_{i}": start for i in range(n)}
    init.update({f"vel_{i}": jnp.zeros((1, 3), dtype) for i in range(n)})
    layer = jt.TheseusLayer(jt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True))
    want, winfo = layer.forward(init)

    got, info = se2_planning.plan(n, dt, iters, nh_w, device="cpu")
    np.testing.assert_allclose(float(info.last_err[0]), float(winfo.last_err[0]), rtol=1e-8, atol=1e-12)
    for i in range(n):
        for k in (f"pose_{i}", f"vel_{i}"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-8, err_msg=k)


def _jax_gbp_graph(n, batch, seed, loop_closures):
    """examples/gbp_pose_graph.py's build_graph with a float64 objective."""
    rng = np.random.default_rng(seed)
    gt_t, cur = [], np.zeros((batch, 3))
    for _ in range(n):
        gt_t.append(cur.copy())
        cur = cur + rng.normal(scale=0.5, size=(batch, 3)) * [1, 1, 0.5]
    gt = [jse2.exp(jnp.asarray(t)) for t in gt_t]
    obj = jt.Objective(dtype=jnp.float64)
    poses = [jt.SE2(tensor=jse2.exp(jnp.asarray(gt_t[i] + rng.normal(scale=0.2, size=(batch, 3)))), name=f"x{i}")
             for i in range(n)]
    obj.add(jt.Difference(poses[0], jt.SE2(tensor=gt[0], name="prior_t"), jt.ScaleCostWeight(100.0), name="prior"))
    for i, j in [(i, i + 1) for i in range(n - 1)] + loop_closures:
        meas = jse2.compose(jse2.inverse(gt[i]), gt[j])
        obj.add(jt.Between(poses[i], poses[j], jt.SE2(tensor=meas, name=f"m{i}_{j}"), jt.ScaleCostWeight(1.0),
                           name=f"e{i}_{j}"))
    return obj


def test_gbp_pose_graph_matches_jax():
    n, batch, seed, sweeps, damping, iters = 6, 2, 0, 25, 0.4, 8
    obj = _jax_gbp_graph(n, batch, seed, [(0, n - 1), (1, n // 2)])
    gbp = jt.GaussianBeliefPropagation(obj, max_iterations=iters, msg_iters=sweeps, msg_damping=damping)
    out, info = gbp.optimize()
    _, info_gn = jt.GaussNewton(obj, max_iterations=iters).optimize()
    margs = gbp.marginals(values=out)
    stds = []
    for i in range(n):
        cov = np.linalg.inv(np.asarray(margs[f"x{i}"].precision)[0])
        stds.append(float(np.sqrt(cov[1, 1] + cov[2, 2])))

    got = gbp_pose_graph.run(n, batch, seed, sweeps, damping, iters, dtype=torch.float64, device="cpu",
                             verbose=False)
    for i in range(n):
        np.testing.assert_allclose(got["values"][f"x{i}"].numpy(), np.asarray(out[f"x{i}"]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["gbp_err"].numpy(), np.asarray(info.last_err), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["gn_err"].numpy(), np.asarray(info_gn.last_err), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["stds"], stds, rtol=1e-8)
    assert got["gap"] < 1e-4 and got["stds"][0] < got["stds"][n // 2]


def test_motion_planning_learned_step_matches_jax():
    jmod = load_jax_example("motion_planning_learned")
    from theseus_tpu.utils.examples.motion_planning import (MotionPlanner, create_collision_weight_model,
                                                            create_initial_trajectory_model)

    batch, inner = 2, 3
    start, goal, sdf = jmod.make_problems(jax.random.PRNGKey(5), batch)
    planner = MotionPlanner(map_size=jmod.MAP_SIZE, epsilon_dist=0.4, total_time=jmod.TOTAL_TIME,
                            collision_weight=20.0, Qc_inv=[[1.0, 0.0], [0.0, 1.0]], num_time_steps=jmod.NUM_STEPS,
                            max_iterations=inner, dtype=jnp.float64, learnable_collision_weight=True)
    obj, co, opts, layer = planner.objective, planner.objective.compile(), planner.optimizer.opts, planner.layer
    traj_params, traj_apply = create_initial_trajectory_model(jmod.NUM_STEPS, jax.random.PRNGKey(1))
    cw_params, cw_apply = create_collision_weight_model(jax.random.PRNGKey(2))

    def loss_fn(params):  # the JAX script's
        init = traj_apply(params["traj"], start, goal, jmod.TOTAL_TIME)
        feat = jnp.mean(jnp.minimum(sdf, 1.0), axis=(1, 2))[:, None]
        values = dict(init)
        values.update(start=start, goal=goal, sdf_origin=jnp.zeros((batch, 2)), sdf_data=sdf,
                      cell_size=jnp.full((batch, 1), jmod.CELL), collision_w=cw_apply(params["cw"], feat))
        values = obj.default_values(values)
        carry = layer.solve_state(co.pack(values, batch), co.build_aux(values, batch), "truncated", opts, 1)
        return jnp.mean(carry["err"])

    want, jg = jax.jit(jax.value_and_grad(loss_fn))({"traj": traj_params, "cw": cw_params})

    def mlp(p):
        return mlp_from_params([{k: np.asarray(v) for k, v in layer.items()} for layer in p], dtype=torch.float64,
                               device="cpu")

    traj_model = InitialTrajectoryModel(jmod.NUM_STEPS, mlp=mlp(traj_params))
    cw_model = CollisionWeightModel(mlp=mlp(cw_params))
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    loss = motion_planning_learned.loss_fn(motion_planning_learned.make_planner(inner, device="cpu"), traj_model,
                                           cw_model, f(start), f(goal), f(sdf))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-8)
    for model, key in ((traj_model, "traj"), (cw_model, "cw")):
        for i, layer_g in enumerate(jg[key]):
            for p, w in ((model.mlp.weights[i], layer_g["w"]), (model.mlp.biases[i], layer_g["b"])):
                w = np.asarray(w)
                got = torch.zeros_like(p) if p.grad is None else p.grad
                np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-8 * max(float(np.abs(w).max()), 1e-12))
    assert float(cw_model.mlp.weights[0].grad.abs().max()) > 0.0


def test_motion_planning_problems_match_jax_draws():
    """The port's problem maker on the JAX script's draws gives its problems."""
    jmod = load_jax_example("motion_planning_learned")
    key = jax.random.PRNGKey(5)
    start, goal, sdf = jmod.make_problems(key, 3)
    k1, k2 = jax.random.split(key)
    ks = jax.random.split(k1, 3)
    side = jmod.MAP_SIZE * jmod.CELL
    centers = jax.random.uniform(ks[0], (3, 2, 2), minval=0.8, maxval=side - 0.8)
    radii = jax.random.uniform(ks[1], (3, 2), minval=0.3, maxval=0.6)
    jitter = 0.3 * jax.random.normal(k2, (3, 4))
    got = motion_planning_learned.problems(*(torch.as_tensor(np.asarray(a)) for a in (centers, radii, jitter)))
    for g, w in zip(got, (start, goal, sdf)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)
