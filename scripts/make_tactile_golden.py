#!/usr/bin/env python3
"""Write the JAX float64 golden of the tactile learning path: tests/fixtures/tactile_12x4_jax_f64.npz.

The episode is theseus_tpu_torch's `synthetic_push` (numpy seed 0) at
T = 12 steps, batch 4, features of dim 8, moving-frame windows 1..3 step 1;
the models are the JAX package's `create_tactile_models(8,
PRNGKey(0))`. Through the JAX package's `TactilePoseEstimator` (3 LM
iterations, the default dense linearization) and `TactileTrainer`, on the
CPU in float64, for the unroll and implicit backward modes: the object
poses of the solution (B, T, 4), the loss and its gradient with respect to
every MLP parameter. The file also holds the episode's inputs and the
parameters, so that a reader needs no JAX: chip_smoke.py's `tactile` phase
and tests/test_torch_tactile_golden.py hold the port to it.

    JAX_PLATFORMS=cpu python3 scripts/make_tactile_golden.py

This script imports jax and the JAX package (and the port, for the
episode's numpy arrays); the port does not import it.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "tactile_12x4_jax_f64.npz"
T, BATCH, FEATURES, SEED, ITERS = 12, 4, 8, 0, 3
MODES = ("unroll", "implicit")


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT))
    from theseus_tpu.utils.examples.tactile_pose_estimation import TactilePoseEstimator, TactileTrainer
    from theseus_tpu_torch.utils.examples import tactile_pose_estimation as port

    t0 = time.perf_counter()
    base, obj_gt, _, feats = port.synthetic_push(port.TactilePoseEstimator(T, device="cpu"), batch=BATCH,
                                                 feature_dim=FEATURES, seed=SEED)
    est = TactilePoseEstimator(T, max_iterations=ITERS, dtype=jnp.float64)
    out = {"time_steps": T, "batch": BATCH, "feature_dim": FEATURES, "seed": SEED, "iters": ITERS,
           "obj_gt": obj_gt, "features": np.stack([feats[i] for i in range(T)])}
    out.update({f"in_{k}": np.asarray(v) for k, v in base.items()})
    jbase = {k: jnp.asarray(v) for k, v in base.items()}
    jfeats = {i: jnp.asarray(v) for i, v in feats.items()}
    for mode in MODES:
        tr = TactileTrainer(est, FEATURES, key=jax.random.PRNGKey(0), backward_mode=mode)
        if mode == MODES[0]:
            for part in ("meas", "weight"):
                for i, layer in enumerate(tr.params[part]):
                    out[f"{part}_w{i}"], out[f"{part}_b{i}"] = np.asarray(layer["w"]), np.asarray(layer["b"])
        co = est.objective.compile()

        def loss_and_sol(params, tr=tr, mode=mode):
            # TactileTrainer.loss, also returning the object poses
            values = est.objective.default_values(tr.build_inputs(jbase, params, jfeats))
            bsz = co.resolve_batch_size(values)
            carry = est.layer.solve_state(co.pack(values, bsz), co.build_aux(values, bsz), mode, est.optimizer.opts)
            sol = co.unpack(carry["state"])
            poses = jnp.stack([sol[f"obj_pose_{i}"] for i in range(T)], axis=1)
            return jnp.mean((poses[..., :2] - jnp.asarray(obj_gt)[None, :, :2]) ** 2), poses

        (loss, poses), grads = jax.jit(jax.value_and_grad(loss_and_sol, has_aux=True))(tr.params)
        check = float(tr.loss(tr.params, jbase, jfeats, jnp.asarray(obj_gt)))
        assert abs(check - float(loss)) <= 1e-12 * abs(check), (check, float(loss))
        out[f"loss_{mode}"], out[f"sol_{mode}"] = float(loss), np.asarray(poses)
        for part in ("meas", "weight"):
            for i, layer in enumerate(grads[part]):
                out[f"grad_{mode}_{part}_w{i}"] = np.asarray(layer["w"])
                out[f"grad_{mode}_{part}_b{i}"] = np.asarray(layer["b"])
        print(f"{mode}: loss {float(loss):.12e}")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
