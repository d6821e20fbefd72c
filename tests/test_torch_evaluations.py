"""The evaluation scripts of theseus_tpu_torch (evaluations_torch/) against the JAX scripts' own functions, on the CPU, in float64.

The JAX evaluation scripts are loaded by path (evaluations/ has no
package). Where a JAX script draws its inputs with jax.random, the same
draws are fed to the port's builder; the JAX objectives, float32 by the
scripts' default, are compiled in float64.

- backward_modes_sweep: the gradient of `make_outer_loss` in unroll,
  implicit, truncated(2) and dlm at PGO 6 x 2, 4 GN iterations (1e-8
  relative);
- vectorization_ablation: the final LM error after 3 iterations at PGO
  8 x 2, compiled with vectorize False and True (1e-10);
- autodiff_ablation: the linearized jacobians and errors of the
  reprojection (analytic, fwd, rev) and photometric (fwd, rev) objectives
  (1e-10);
- gbp_eval: the GBP step-quality numbers on its 16-pose graph (1e-8);
- time_local_cost_backward: the 3-iteration solve and the gradient of its
  error in the input, SO3 and SE3 (1e-10);

The scripts' main() runs are tests/test_torch_evaluations_run.py.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EVALS = ROOT / "evaluations"
sys.path.insert(0, str(ROOT))

from evaluations_torch import (  # noqa: E402
    autodiff_ablation,
    backward_modes_sweep,
    gbp_eval,
    time_local_cost_backward,
    vectorization_ablation,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the port's side: its many tiny ops (GBP's
    6 x 6 solves) crawl when every xdist worker's thread pool spins on the
    same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def load_jax_eval(name):
    spec = importlib.util.spec_from_file_location(f"jax_eval_{name}", EVALS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_graph(n_poses, batch):
    """The JAX package's synthetic_pose_graph (seed 0, float64) as the
    (gt, edges, measurements, init) the port's builders take."""
    from theseus_tpu.utils.examples.pose_graph import synthetic_pose_graph

    gt, edges, meas, init = synthetic_pose_graph(n_poses=n_poses, batch=batch, seed=0, dtype=jnp.float64)
    return gt, (_t(gt), edges, _t(meas), _t(init))


def test_backward_mode_gradients_match_jax():
    jmod = load_jax_eval("backward_modes_sweep")
    n, b, iters, theta = 6, 2, 4, 0.3
    jparts = jmod.build(n, b, iters, dtype=jnp.float64)
    _, graph = _jax_graph(n, b)
    parts = backward_modes_sweep.build(n, b, iters, dtype=torch.float64, device="cpu", graph=graph)
    modes = [("unroll", None), ("implicit", None), ("truncated", 2), ("dlm", None)]
    grads = jax.jit(lambda th: [jax.grad(jmod.make_outer_loss(*jparts, m, k or 4))(th) for m, k in modes])
    want = [float(g) for g in grads(jnp.asarray(theta, jnp.float64))]
    for (mode, k), w in zip(modes, want):
        loss = backward_modes_sweep.make_outer_loss(*parts, mode, k or 4)
        got = float(backward_modes_sweep.gradient(loss, theta, torch.float64, "cpu"))
        np.testing.assert_allclose(got, w, rtol=1e-8, err_msg=f"{mode}({k})")


def test_vectorize_arms_match_jax():
    jmod = load_jax_eval("vectorization_ablation")
    n, b, iters = 8, 2, 3
    _, graph = _jax_graph(n, b)
    for vec in (False, True):
        jlayer, jstate, jaux = jmod.build(n, b, vec, dtype=jnp.float64)
        opt = jlayer.optimizer

        @jax.jit
        def jsolve(state, aux):
            return opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, iters, opt.opts)["err"]

        want = np.asarray(jsolve(jstate, jaux))
        layer, state, aux = vectorization_ablation.build(n, b, vec, torch.float64, "cpu", graph=graph)
        n_buckets = len(layer.objective.compile().buckets)
        assert n_buckets == (len(graph[1]) + 1 if not vec else 2)  # one a cost, or Local and Between
        got = vectorization_ablation.lm_solver(layer, state, aux)(iters).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10, err_msg=f"vectorize={vec}")


def _linearized(blocks):
    out = []
    for jacs, err in blocks:
        out += [np.asarray(j) for j in jacs] + [np.asarray(err)]
    return out


def _jax_linearize(obj, vals):
    obj.dtype = jnp.float64  # the script's objective is float32 by default
    co = obj.compile()
    b = co.resolve_batch_size(vals)
    state, aux = co.pack(obj.default_values(vals), b), co.build_aux(obj.default_values(vals), b)
    return _linearized(jax.jit(co.linearize_blocks)(state, aux))


@pytest.mark.parametrize("shape,mode", [("reprojection", "analytic"), ("reprojection", "fwd"),
                                        ("reprojection", "rev"), ("photometric", "fwd"), ("photometric", "rev")])
def test_autodiff_ablation_jacobians_match_jax(shape, mode):
    jmod = load_jax_eval("autodiff_ablation")
    n, batch, patch = 4, 2, 8
    if shape == "reprojection":
        jobj, jvals = jmod.reprojection_objective(mode, n=n, batch=batch)
        uv = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (batch, 2)))
        obj, vals = autodiff_ablation.reprojection_objective(mode, n=n, batch=batch, device="cpu", uv=uv,
                                                             dtype=torch.float64)
    else:
        jobj, jvals = jmod.photometric_objective(mode, n=n, batch=batch, patch=patch)
        key = jax.random.PRNGKey(1)
        pix = [np.asarray(jax.random.normal(jax.random.fold_in(key, i), (batch, patch * patch, 3))) for i in range(n)]
        obj, vals = autodiff_ablation.photometric_objective(mode, n=n, batch=batch, patch=patch, device="cpu",
                                                            pix=pix, dtype=torch.float64)
    want = _jax_linearize(jobj, jvals)
    got = _linearized(autodiff_ablation.linearizer(obj, vals)())
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_gbp_step_quality_matches_jax():
    jmod = load_jax_eval("gbp_eval")
    for damping in (0.0, 0.3):
        want = jmod.step_quality(jmod.build(16), damping)
        got = gbp_eval.step_quality(gbp_eval.build(16, device="cpu"), damping)
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=f"damping={damping}")


@pytest.mark.parametrize("group", ["SO3", "SE3"])
def test_local_cost_solve_matches_jax(group):
    jmod = load_jax_eval("time_local_cost_backward")
    batch, dof = 4, time_local_cost_backward.DOF[group]
    jlayer, jco, jstate, jaux, _ = jmod.build(group, batch, jnp.float64)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tangents = [np.asarray(jax.random.normal(k, (batch, dof), jnp.float64)) for k in (k1, k2)]
    layer, co, state, aux, _ = time_local_cost_backward.build(group, batch, torch.float64, "cpu", tangents=tangents)
    np.testing.assert_allclose(state[group].numpy(), np.asarray(jstate[group]), rtol=0, atol=1e-12)
    opts = jlayer.optimizer.opts

    def jloss(a_in):
        st = dict(jstate)
        st[group] = a_in
        carry = jlayer.solve_state(st, jaux, "unroll", opts)
        return jnp.sum(carry["err"]), carry

    (jl, jcarry), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jstate[group])
    a_in = state[group].clone().requires_grad_(True)
    st = dict(state)
    st[group] = a_in
    carry = layer.solve_state(st, aux, "unroll", layer.optimizer.opts)
    (g,) = torch.autograd.grad(torch.sum(carry["err"]), [a_in])
    np.testing.assert_allclose(carry["err"].detach().numpy(), np.asarray(jcarry["err"]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(carry["state"][group].detach().numpy(), np.asarray(jcarry["state"][group]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-10)
    # the script's step: the SGD update of the input by that gradient
    step = time_local_cost_backward.stepper(layer, state, aux, group, backward=True)
    nxt, loss = step(state[group], 0.0)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-12)
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jstate[group] - 0.01 * jg), rtol=0, atol=1e-10)
