"""GPMP2-style motion planning in theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `MotionPlanner` on 16 x 16 maps (cell 0.25 m, obstacles from a numpy
  seed through occupancy_to_sdf), 10 time steps, batch 2, on the dense and
  the sparse linearization (block size 2: Point2 poses and Vector(2)
  velocities), under Gauss-Newton, Levenberg-Marquardt (adaptive damping)
  and Dogleg, 20 iterations from the straight line: final error, error
  history and trajectory against the JAX package's planner, 1e-8.
- The learned initialization of examples/motion_planning_learned.py: the
  JAX package's initial-trajectory and collision-weight MLPs (build_mlp
  parameters from a PRNG key) carried into the port's nn.Modules by
  `utils.convert.mlp_from_params`, three LM iterations unrolled on the
  sparse plan, the outer loss (the mean final error) and its gradient with
  respect to every MLP parameter against jax.grad of the same loss, 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils.examples import motion_planning as jmp
import theseus_tpu_torch as tt
from theseus_tpu_torch.embodied import occupancy_to_sdf
from theseus_tpu_torch.utils.convert import mlp_from_params
from theseus_tpu_torch.utils.examples.motion_planning import (
    CollisionWeightModel,
    InitialTrajectoryModel,
    MotionPlanner,
)

MAP, CELL, STEPS, B, TOTAL_TIME = 16, 0.25, 10, 2, 2.0
TOL = 1e-8


def _problem(seed=0):
    """Maps with a 3 x 4-cell box each, start and goal near the left and
    right edges of the map at half height (examples/motion_planning_2d.py's
    fractions), jittered."""
    rng = np.random.default_rng(seed)
    sdfs = []
    for _ in range(B):
        occ = np.zeros((MAP, MAP))
        r0, c0 = rng.integers(4, 10, 2)
        occ[r0:r0 + 3, c0:c0 + 4] = 1.0
        sdfs.append(occupancy_to_sdf(occ, CELL))
    ext = MAP * CELL
    start = np.array([[0.09375 * ext, 0.5 * ext]] * B) + rng.normal(0, 0.05, (B, 2))
    goal = np.array([[0.90625 * ext, 0.5 * ext]] * B) + rng.normal(0, 0.05, (B, 2))
    return start, goal, np.stack(sdfs)


OPTIMIZERS = {"gn": ("GaussNewton", {}), "lm": ("LevenbergMarquardt", {"adaptive_damping": True}),
              "dogleg": ("Dogleg", {})}


@pytest.mark.parametrize("lin", ["dense", "sparse"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_planner_matches_jax(lin, opt):
    start, goal, sdf = _problem()
    cls, kw = OPTIMIZERS[opt]
    jp = jmp.MotionPlanner(MAP, 0.4, TOTAL_TIME, 20.0, np.eye(2), STEPS, optimizer_cls=getattr(jt, cls),
                           max_iterations=20, linearization=lin, **kw)
    jv, jinfo = jp.solve(jnp.asarray(start), jnp.asarray(goal), jnp.zeros((B, 2)), jnp.asarray(sdf),
                         jnp.full((B, 1), CELL))
    planner = MotionPlanner(MAP, 0.4, TOTAL_TIME, 20.0, np.eye(2), STEPS, optimizer_cls=getattr(tt, cls),
                            max_iterations=20, device="cpu", linearization=lin, **kw)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    values, info = planner.solve(f(start), f(goal), torch.zeros(B, 2, dtype=torch.float64), f(sdf),
                                 torch.full((B, 1), CELL, dtype=torch.float64))
    if lin == "sparse":
        assert planner.optimizer.normal_builder.pattern.d == 2
    traj = planner.trajectory(values)
    assert tuple(traj.shape) == (B, STEPS + 1, 2)
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=TOL)
    np.testing.assert_allclose(info.err_history.numpy(), np.asarray(jinfo.err_history), rtol=TOL)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jp.trajectory(jv)), rtol=TOL, atol=TOL)
    for i in range(STEPS + 1):
        np.testing.assert_allclose(values[f"vel_{i}"].numpy(), np.asarray(jv[f"vel_{i}"]), rtol=TOL, atol=TOL)
    assert float(info.last_err.max()) < 0.1 * float(info.err_history[0].min())


def _feature(sdf):
    return sdf.clip(max=1.0).mean(axis=(1, 2))[:, None]


def test_learned_initialization_gradient_matches_jax():
    start, goal, sdf = _problem(seed=1)
    iters = 3
    # JAX: the example's loss with the layer's unrolled solve
    jplanner = jmp.MotionPlanner(MAP, 0.4, TOTAL_TIME, 20.0, np.eye(2), STEPS, max_iterations=iters,
                                 linearization="sparse", learnable_collision_weight=True)
    jobj, jco, jopts = jplanner.objective, jplanner.objective.compile(), jplanner.optimizer.opts
    traj_params, traj_apply = jmp.create_initial_trajectory_model(STEPS, jax.random.PRNGKey(1))
    cw_params, cw_apply = jmp.create_collision_weight_model(jax.random.PRNGKey(2))

    def jloss(params):
        init = traj_apply(params["traj"], jnp.asarray(start), jnp.asarray(goal), TOTAL_TIME)
        values = dict(init, start=jnp.asarray(start), goal=jnp.asarray(goal), sdf_origin=jnp.zeros((B, 2)),
                      sdf_data=jnp.asarray(sdf), cell_size=jnp.full((B, 1), CELL),
                      collision_w=cw_apply(params["cw"], jnp.asarray(_feature(sdf))))
        values = jobj.default_values(values)
        carry = jplanner.layer.solve_state(jco.pack(values, B), jco.build_aux(values, B), "unroll", jopts)
        return jnp.mean(carry["err"])

    params = {"traj": traj_params, "cw": cw_params}
    jl, jg = jax.value_and_grad(jloss)(params)

    # the port: the same parameters in nn.Modules, the layer's unroll mode
    def mlp(p):
        return mlp_from_params([{k: np.asarray(v) for k, v in layer.items()} for layer in p],
                               dtype=torch.float64, device="cpu")

    traj_model = InitialTrajectoryModel(STEPS, mlp=mlp(traj_params))
    cw_model = CollisionWeightModel(mlp=mlp(cw_params))
    planner = MotionPlanner(MAP, 0.4, TOTAL_TIME, 20.0, np.eye(2), STEPS, max_iterations=iters, device="cpu",
                            linearization="sparse", learnable_collision_weight=True)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    init = traj_model(f(start), f(goal), TOTAL_TIME)
    inputs = dict(init, start=f(start), goal=f(goal), sdf_origin=torch.zeros(B, 2, dtype=torch.float64),
                  sdf_data=f(sdf), cell_size=torch.full((B, 1), CELL, dtype=torch.float64),
                  collision_w=cw_model(f(_feature(sdf))))
    _, info = planner.layer.forward(inputs, optimizer_kwargs={"backward_mode": "unroll"})
    loss = info.last_err.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
    for model, key in ((traj_model, "traj"), (cw_model, "cw")):
        for i, layer in enumerate(jg[key]):
            w_grad, b_grad = model.mlp.weights[i].grad.numpy(), model.mlp.biases[i].grad.numpy()
            scale = max(1e-12, float(np.abs(np.asarray(layer["w"])).max()))
            np.testing.assert_allclose(w_grad, np.asarray(layer["w"]), rtol=TOL, atol=TOL * scale)
            np.testing.assert_allclose(b_grad, np.asarray(layer["b"]), rtol=TOL,
                                       atol=TOL * max(1e-12, float(np.abs(np.asarray(layer["b"])).max())))
    assert float(np.abs(traj_model.mlp.weights[0].grad.numpy()).max()) > 0.0
