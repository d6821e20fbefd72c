"""Backward modes on the tactile learning task (the port of evaluations/backward_modes_tactile.py, the vehicle of the Theseus paper's Fig. 4).

Tactile pose estimation (utils/examples/tactile_pose_estimation.py) with
learned measurement and weight models (nn.Modules) trained through the LM
solve. For each mode (unroll, implicit, truncated-5, truncated-10, dlm) at
each count of inner iterations:

- ms/grad: the outer loss and its gradient with respect to both models'
  parameters and a scalar knob theta on the learned moving-frame weight,
  by `torch.autograd.grad`, the minimum of 3 synced calls (theta moved by
  1e-9 each call);
- the gradient in theta against the central difference of the loss
  (1e-6 in float64; 1e-3 in float32, where the FD floor dominates);
- a 10-step learning run (SGD at 1e-2): the outer loss before and after.

The estimator solves on the sparse linearization, so the assembly and the
level factorization and substitution kernels run on the card (the JAX
script leaves LM on its default dense linearization; the solution is the
same). A cell that runs out of device memory is recorded as failed; any
other error raises. Runs on the card unless --device cpu is given.

    python evaluations_torch/backward_modes_tactile.py [--time-steps 10] [--inner-iters 3 10 20] [--f32] [--out-suffix S] [--device cpu]

Writes evaluations_torch/results_backward_modes_tactile<S>.md.
"""

import argparse
import functools
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from theseus_tpu_torch.embodied import occupancy_to_sdf
from theseus_tpu_torch.utils.examples.tactile_pose_estimation import TactilePoseEstimator, TactileTrainer

OUT = pathlib.Path(__file__).resolve().parent / "results_backward_modes_tactile.md"

MODES = [("unroll", 0), ("implicit", 0), ("truncated", 5), ("truncated", 10), ("dlm", 0)]
FEATURE_DIM = 6
LEARN_STEPS, LEARN_RATE = 10, 1e-2


def make_inputs(est, dtype=torch.float64, device=None):
    """A straight +x push (the episode of the JAX package's
    tests/embodied/test_tactile.py): (base inputs, obj_gt (T, 4))."""
    t = est.time_steps
    xs = torch.linspace(0.1, 0.2, t, dtype=dtype, device=device)
    obj_gt = torch.stack([xs, torch.full_like(xs, 0.16), torch.ones_like(xs), torch.zeros_like(xs)], dim=-1)
    eff_gt = obj_gt.clone()
    eff_gt[:, 0] -= 0.03
    occ = np.zeros((32, 32))
    occ[12:20, 12:20] = 1.0
    sdf = occupancy_to_sdf(occ, 0.01)
    inputs = {"obj_start_pose": obj_gt[:1], "sdf_data": torch.as_tensor(sdf, dtype=dtype, device=device)[None]}
    for i in range(t):
        inputs[f"motion_capture_{i}"] = eff_gt[i][None]
        inputs[f"obj_pose_{i}"] = obj_gt[0][None]
        inputs[f"eff_pose_{i}"] = eff_gt[i][None]
    return inputs, obj_gt


def build(time_steps, inner_iters, dtype, device):
    """(estimator, trainer, base inputs, features, obj_gt); the models and
    the features drawn from CPU generators seeded 0."""
    est = TactilePoseEstimator(time_steps=time_steps, max_iterations=inner_iters, dtype=dtype, device=device,
                               optimizer_cls=functools.partial(tt.LevenbergMarquardt, linearization="sparse"))
    base, obj_gt = make_inputs(est, dtype, device)
    gen = torch.Generator().manual_seed(0)
    feats = {i: torch.randn((1, FEATURE_DIM), generator=gen, dtype=dtype).to(device) for i in range(time_steps)}
    trainer = TactileTrainer(est, FEATURE_DIM, generator=torch.Generator().manual_seed(0), lr=1e-3, dtype=dtype,
                             device=device)
    return est, trainer, base, feats, obj_gt


def loss_fn(trainer, est, mode, bwd_iters):
    """loss(theta, base_inputs, features, obj_gt): the mean squared xy error
    of the solved object trajectory, theta a scalar on the learned
    moving-frame weight (its gradient flows through the same solve as the
    models')."""
    co = est.objective.compile()

    def loss(theta, base_inputs, features, obj_gt):
        inputs = trainer.build_inputs(base_inputs, features)
        inputs["mf_between_weight"] = inputs["mf_between_weight"] * theta
        values = est.objective.default_values(inputs)
        bsz = co.resolve_batch_size(values)
        state, aux = co.pack(values, bsz), co.build_aux(values, bsz)
        carry = est.layer.solve_state(state, aux, mode, est.optimizer.opts, backward_num_iterations=bwd_iters or 5)
        sol = co.unpack(carry["state"])
        pred = torch.stack([sol[f"obj_pose_{i}"] for i in range(est.time_steps)], dim=1)
        return torch.mean((pred[..., :2] - obj_gt[None, :, :2]) ** 2)

    return loss


def run_mode(mode, bwd_iters, time_steps, inner_iters, dtype, device, reps=3):
    est, trainer, base, feats, obj_gt = build(time_steps, inner_iters, dtype, device)
    loss = loss_fn(trainer, est, mode, bwd_iters)
    params = trainer.parameters()

    def value_and_grad(theta):
        th = torch.tensor(theta, dtype=dtype, device=device, requires_grad=True)
        val = loss(th, base, feats, obj_gt)
        *gp, gth = torch.autograd.grad(val, params + [th])
        return val.detach(), gp, gth

    val, _, gtheta = value_and_grad(1.0)
    eps = 1e-6 if dtype == torch.float64 else 1e-3
    with torch.no_grad():
        lp, lm = (float(loss(torch.tensor(1.0 + s, dtype=dtype, device=device), base, feats, obj_gt))
                  for s in (eps, -eps))
    fd, g = (lp - lm) / (2 * eps), float(gtheta)
    rel = abs(g - fd) / max(abs(fd), 1e-12)

    ms_grad = min(_common.synced_s(lambda: value_and_grad(1.0 + 1e-9 * (i + 1))[2], device)[1]
                  for i in range(reps)) * 1e3

    losses = [float(val)]
    for _ in range(LEARN_STEPS):
        v, gp, _ = value_and_grad(1.0)
        with torch.no_grad():
            for p, gg in zip(params, gp):
                p -= LEARN_RATE * gg
        losses.append(float(v))
    return {"mode": mode if not bwd_iters else f"{mode}-{bwd_iters}", "inner_iters": inner_iters, "grad": g,
            "fd": fd, "rel_err": rel, "ms_grad": ms_grad, "loss0": losses[0], "loss10": losses[-1]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--time-steps", type=int, default=10)
    p.add_argument("--inner-iters", type=int, nargs="+", default=[3, 10, 20])
    p.add_argument("--f32", action="store_true", help="float32 (the timing tier; the FD column is noise-floored)")
    p.add_argument("--out-suffix", default="")
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)
    dtype = torch.float32 if a.f32 else torch.float64

    rows = []
    for inner in a.inner_iters:
        for mode, bwd in MODES:
            r, failed = _common.or_out_of_memory(lambda: run_mode(mode, bwd, a.time_steps, inner, dtype, dev),
                                                 f"{mode}-{bwd} inner={inner}")
            if failed:
                nan = math.nan
                rows.append({"mode": f"{mode}-{bwd}" if bwd else mode, "inner_iters": inner, "rel_err": nan,
                             "ms_grad": nan, "loss0": nan, "loss10": nan, "note": failed})
                continue
            rows.append(r)
            print(f"[{dev.type}] inner={inner:3d} {r['mode']:<12s} ms/grad={r['ms_grad']:9.2f} "
                  f"rel_err={r['rel_err']:.2e} loss {r['loss0']:.4e} -> {r['loss10']:.4e}", flush=True)

    notes = (f"{a.time_steps} time steps, batch 1, {'float32' if a.f32 else 'float64'}, on {dev.type}. Outer loss: "
             "MSE of the estimated object trajectory against ground truth, learned MLP measurement and weight "
             "models through the LM solve (sparse linearization). rel err: the gradient in a scalar knob on the "
             f"learned weight against its central difference ({'1e-3' if a.f32 else '1e-6'}).")
    table = [[str(r["inner_iters"]), r["mode"] + (" " + r["note"] if "note" in r else ""), f"{r['ms_grad']:.2f}",
              f"{r['rel_err']:.2e}", f"{r['loss0']:.4e}", f"{r['loss10']:.4e}"] for r in rows]
    out = OUT if not a.out_suffix else OUT.with_name(OUT.stem + a.out_suffix + ".md")
    _common.write_results(
        out, "Backward modes on the tactile learning task, theseus_tpu_torch",
        [_common.Section(f"{a.time_steps} time steps, {'float32' if a.f32 else 'float64'}", notes,
                         ["inner iters", "mode", "ms/grad", "grad rel err vs FD", "loss step0", "loss step10"],
                         table)],
        card, fresh=True)
    return rows


if __name__ == "__main__":
    main()
