"""The committed JAX float64 golden of the tactile learning path (tests/fixtures/tactile_12x4_jax_f64.npz, scripts/make_tactile_golden.py), on the CPU.

- the fixture against what it was made from: its episode equals
  `synthetic_push` regenerated from its seed (exactly), its parameters
  the JAX package's `create_tactile_models(8, PRNGKey(0))` (exactly), and
  its implicit-mode loss the JAX package's `TactileTrainer.loss` now
  (1e-12 relative);
- the port on the CPU in float64 against it, on the dense and the sparse
  linearization, in the unroll and implicit modes: the object poses
  (1e-8), the loss (1e-10 relative) and every parameter's gradient (1e-7
  relative to its largest entry). chip_smoke.py's `tactile` phase holds
  the card's float64 kernels to the same file.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.utils.examples.tactile_pose_estimation import TactilePoseEstimator as JEstimator
from theseus_tpu.utils.examples.tactile_pose_estimation import TactileTrainer as JTrainer
from theseus_tpu.utils.examples.tactile_pose_estimation import create_tactile_models as jcreate_models
import theseus_tpu_torch as tt
from theseus_tpu_torch.models import tactile
from theseus_tpu_torch.utils.convert import tactile_models_from_params, tactile_params_from_arrays

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "tactile_12x4_jax_f64.npz"


@functools.lru_cache(maxsize=None)
def _golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def _episode(g):
    base = {k[3:]: v for k, v in g.items() if k.startswith("in_")}
    feats = {i: g["features"][i] for i in range(int(g["time_steps"]))}
    return base, feats, g["obj_gt"]


def test_fixture_matches_its_sources():
    g = _golden()
    t, b, f, seed = (int(g[k]) for k in ("time_steps", "batch", "feature_dim", "seed"))
    base, feats, obj_gt = _episode(g)
    rb, robj, _, rfeats = tactile.synthetic_push(tactile.TactilePoseEstimator(t, device="cpu"), batch=b,
                                                 feature_dim=f, seed=seed)
    assert set(rb) == set(base)
    for k in rb:
        np.testing.assert_array_equal(base[k], rb[k])
    for i in range(t):
        np.testing.assert_array_equal(feats[i], rfeats[i])
    np.testing.assert_array_equal(obj_gt, robj)
    params, _, _ = jcreate_models(f, jax.random.PRNGKey(0))
    mine = tactile_params_from_arrays(g)
    for part in ("meas", "weight"):
        assert len(mine[part]) == len(params[part])
        for a, w in zip(mine[part], params[part]):
            np.testing.assert_array_equal(a["w"], np.asarray(w["w"]))
            np.testing.assert_array_equal(a["b"], np.asarray(w["b"]))
    est = JEstimator(t, max_iterations=int(g["iters"]), dtype=jnp.float64)
    tr = JTrainer(est, f, key=jax.random.PRNGKey(0), backward_mode="implicit")
    loss = jax.jit(tr.loss)(tr.params, {k: jnp.asarray(v) for k, v in base.items()},
                            {i: jnp.asarray(v) for i, v in feats.items()}, jnp.asarray(obj_gt))
    np.testing.assert_allclose(float(loss), float(g["loss_implicit"]), rtol=1e-12)


@pytest.mark.parametrize("linearization", ["dense", "sparse"])
@pytest.mark.parametrize("mode", ["unroll", "implicit"])
def test_port_matches_the_committed_jax_golden(mode, linearization):
    g = _golden()
    t, f = int(g["time_steps"]), int(g["feature_dim"])
    base, feats, obj_gt = _episode(g)
    est = tactile.TactilePoseEstimator(t, max_iterations=int(g["iters"]), device="cpu",
                                       optimizer_cls=functools.partial(tt.LevenbergMarquardt,
                                                                       linearization=linearization))
    tr = tactile.TactileTrainer(est, f, backward_mode=mode, models=tactile_models_from_params(
        tactile_params_from_arrays(g), dtype=torch.float64, device="cpu"))
    sol = tr.solve(base, {i: torch.as_tensor(v) for i, v in feats.items()})
    poses = torch.stack([sol[f"obj_pose_{i}"] for i in range(t)], dim=1)
    loss = torch.mean((poses[..., :2] - torch.as_tensor(obj_gt)[None, :, :2]) ** 2)
    np.testing.assert_allclose(poses.detach().numpy(), g[f"sol_{mode}"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(loss), float(g[f"loss_{mode}"]), rtol=1e-10)
    params = [p for m in (tr.meas_model.mlp, tr.weight_model.mlp) for pair in zip(m.weights, m.biases)
              for p in pair]
    names = [f"{part}_{k}{i}" for part, n in (("meas", 3), ("weight", 2)) for i in range(n) for k in ("w", "b")]
    for grad, name in zip(torch.autograd.grad(loss, params), names):
        want = g[f"grad_{mode}_{name}"]
        np.testing.assert_allclose(grad.numpy(), want, rtol=0, atol=1e-7 * max(float(np.abs(want).max()), 1e-12))
