"""Tactile pose estimation of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The straight push of tests/embodied/test_tactile.py, batched: the batch
elements differ in their motion-capture noise, initial guesses and
features (`synthetic_push`, numpy seed 0), and both packages read the same
numpy arrays.

- the objective's structure: variable, aux and cost names in JAX's
  insertion order (T = 5 and, for the windows of the Fig. 4 sweep, T = 100
  with windows 10..40 step 5: 459 moving-frame pairs, 200 SE2 variables,
  758 costs);
- forward with the ground-truth measurements at T = 5 and 12 (batch 2,
  3 LM iterations) on the dense and sparse linearizations against JAX's:
  1e-8;
- two SGD steps of the trainer (T = 5, batch 2, features of dim 6, the
  JAX trainer's parameters carried across by `tactile_models_from_params`)
  against JAX's: losses and parameters, 1e-8 (the gradients of every mode:
  tests/test_torch_tactile_grad.py);
- the models alone: the measurement (normalised (cos, sin)) and weight
  (softplus) outputs against JAX's apply functions, 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.optim.nonlinear import LevenbergMarquardt as JLM
from theseus_tpu.utils.examples.tactile_pose_estimation import TactilePoseEstimator as JEstimator
from theseus_tpu.utils.examples.tactile_pose_estimation import TactileTrainer as JTrainer
from theseus_tpu.utils.examples.tactile_pose_estimation import create_tactile_models as jcreate_models
import theseus_tpu_torch as tt
from theseus_tpu_torch.models import tactile
from theseus_tpu_torch.utils.convert import tactile_models_from_params

B, F = 2, 6


def _estimators(t, linearization="dense", **kw):
    jest = JEstimator(t, optimizer_cls=functools.partial(JLM, linearization=linearization), **kw)
    est = tactile.TactilePoseEstimator(t, optimizer_cls=functools.partial(tt.LevenbergMarquardt,
                                                                          linearization=linearization),
                                       device="cpu", **kw)
    return jest, est


def _episode(est, t):
    base, obj_gt, eff_gt, feats = tactile.synthetic_push(est, batch=B, feature_dim=F, seed=0)
    return base, obj_gt, eff_gt, feats


def test_objective_structure_matches_jax():
    jest, est = _estimators(5)
    assert est.pairs == jest.pairs
    assert list(est.objective.cost_functions) == list(jest.objective.cost_functions)
    jco, co = jest.objective.compile(), est.objective.compile()
    assert list(co.var_names) == list(jco.var_names)
    # constants (the prior's weight, the pushing cost's c^2) get process-wide
    # counter names (Variable__<n>) in both packages: compare the named aux
    named = [[n for n in c.aux_defaults if not n.startswith("Variable__")] for c in (co, jco)]
    assert named[0] == named[1] and len(co.aux_defaults) == len(jco.aux_defaults)
    big = tactile.TactilePoseEstimator(100, 10, 40, 5, device="cpu")
    assert len(big.pairs) == 459 and big.pairs == tactile.measurement_windows(100, 10, 40, 5)
    costs = list(big.objective.cost_functions)
    assert len(costs) == 758 and len(big.objective.compile().var_names) == 200
    assert sum(c.startswith("mfb_") for c in costs) == 459 and sum(c.startswith("contact_") for c in costs) == 99


@pytest.mark.parametrize("t,linearization", [(5, "dense"), (12, "dense"), (12, "sparse")])
def test_forward_matches_jax(t, linearization):
    jest, est = _estimators(t, linearization)
    base, obj_gt, eff_gt, _ = _episode(est, t)
    inputs = dict(base, **tactile.relative_measurements(est, obj_gt, eff_gt))
    jout, jinfo = jest.forward({k: jnp.asarray(v) for k, v in inputs.items()})
    out, info = est.forward(inputs)
    for i in range(t):
        for n in (f"obj_pose_{i}", f"eff_pose_{i}"):
            np.testing.assert_allclose(out[n].numpy(), np.asarray(jout[n]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(info.err_history.numpy(), np.asarray(jinfo.err_history), rtol=1e-8)
    # the objects follow the push (+x)
    assert bool((out[f"obj_pose_{t - 1}"][:, 0] > out["obj_pose_0"][:, 0]).all())


@functools.lru_cache(maxsize=None)
def _jax_params():
    params, _, _ = jcreate_models(F, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _flat_grads(jg):
    return [np.asarray(leaf[k]) for part in ("meas", "weight") for leaf in jg[part] for k in ("w", "b")]


def _trainer_pair(mode, t=5):
    jest, est = _estimators(t)
    base, obj_gt, _, feats = _episode(est, t)
    jtr = JTrainer(jest, F, key=jax.random.PRNGKey(0), lr=1e-3, backward_mode=mode)
    tr = tactile.TactileTrainer(est, F, lr=1e-3, backward_mode=mode,
                                models=tactile_models_from_params(_jax_params(), dtype=torch.float64, device="cpu"))
    jin = ({k: jnp.asarray(v) for k, v in base.items()}, {i: jnp.asarray(v) for i, v in feats.items()},
           jnp.asarray(obj_gt))
    tin = (base, {i: torch.as_tensor(v) for i, v in feats.items()}, torch.as_tensor(obj_gt))
    return jtr, tr, jin, tin


def _torch_params(tr):
    m, w = tr.meas_model.mlp, tr.weight_model.mlp
    return [p for mlp in (m, w) for pair in zip(mlp.weights, mlp.biases) for p in pair]


def test_trainer_sgd_steps_match_jax():
    jtr, tr, jin, tin = _trainer_pair("implicit")
    jtr.loss = jax.jit(jtr.loss)  # JAX's step differentiates it; eager would compile every primitive alone
    for _ in range(2):
        np.testing.assert_allclose(tr.step(*tin), jtr.step(*jin), rtol=1e-8)
    for p, w in zip(_torch_params(tr), _flat_grads(jtr.params)):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-8)


def test_models_match_jax():
    params, meas_apply, weight_apply = jcreate_models(F, jax.random.PRNGKey(0))
    meas, weight = tactile_models_from_params(jax.tree_util.tree_map(np.asarray, params), dtype=torch.float64,
                                              device="cpu")
    rng = np.random.default_rng(2)
    fa, fb = rng.standard_normal((3, F)), rng.standard_normal((3, F))
    want = np.asarray(meas_apply(params["meas"], jnp.asarray(fa), jnp.asarray(fb)))
    got = meas(torch.as_tensor(fa), torch.as_tensor(fb)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got[:, 2:], axis=-1), 1.0)
    k = np.array([[1.0], [-3.0], [40.0]])
    np.testing.assert_allclose(weight(torch.as_tensor(k)).detach().numpy(),
                               np.asarray(weight_apply(params["weight"], jnp.asarray(k))), rtol=1e-12)
    gen = torch.Generator().manual_seed(0)
    m2, w2 = tactile.create_tactile_models(8, gen, dtype=torch.float64, device="cpu")
    assert [tuple(p.shape) for p in m2.mlp.weights] == [(16, 64), (64, 64), (64, 4)]
    assert [tuple(p.shape) for p in w2.mlp.weights] == [(1, 64), (64, 3)]


def test_float32_forward_mode_jacobians():
    """A float32 autodiff cost over SE2 with forward-mode jacobians (the
    quasi-static pushing cost): torch.func.jvp gives a 0-d float32 tensor
    times a Python scalar a float64 tangent, which broke the float32
    estimator (mixed dtypes in the cost's matrix product); forward mode
    below float64 now runs in float64. The float32 jacobians and error are
    float32 and match the float64 ones to 1e-6 relative; the float32
    estimator's forward (3 LM iterations, unconverged) lands within 1e-4 of
    the float64 one (2.3e-5 measured)."""
    est32, est64 = (tactile.TactilePoseEstimator(5, device="cpu", dtype=d) for d in (torch.float32, torch.float64))
    cf = est32.objective.cost_functions["qsp_2"]
    rng = np.random.default_rng(3)
    th = rng.uniform(-0.3, 0.3, 4)
    poses = [np.array([*rng.uniform(-0.2, 0.2, 2), np.cos(t), np.sin(t)]) for t in th]
    c = np.array([0.02])
    j32, e32 = cf.jacobians_fn()(tuple(torch.tensor(p, dtype=torch.float32) for p in poses),
                                 (torch.tensor(c, dtype=torch.float32),))
    j64, e64 = cf.jacobians_fn()(tuple(torch.tensor(p) for p in poses), (torch.tensor(c),))
    assert e32.dtype == torch.float32 and all(j.dtype == torch.float32 for j in j32)
    for a, b in zip(list(j32) + [e32], list(j64) + [e64]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6 * max(1.0, float(b.abs().max())))
    base, obj_gt, eff_gt, _ = _episode(est32, 5)
    inputs = dict(base, **tactile.relative_measurements(est32, obj_gt, eff_gt))
    out32, _ = est32.forward(inputs)
    out64, _ = est64.forward(inputs)
    for i in range(5):
        np.testing.assert_allclose(out32[f"obj_pose_{i}"].numpy(), out64[f"obj_pose_{i}"].numpy(), atol=1e-4)
