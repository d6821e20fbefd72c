#!/usr/bin/env python3
"""Serving throughput of theseus_tpu_torch: whole solves per second against batch size, on one GPU.

The port's counterpart of evaluations/serving_throughput.py (which drives
the JAX package). Two problems, each through `TheseusLayer.forward` with
fresh inputs on every timed call and a sync at the end of each call:

- ik: the 7-dof arm of utils/examples/inverse_kinematics.py, an
  AutoDiffCostFunction over forward kinematics, Levenberg-Marquardt with
  adaptive damping on the default dense linearization, 12 iterations from
  zero; each request moves the targets' translations by 1e-7 (i + 1);
- pgo: the 16-pose SE3 chain of utils/examples/pose_graph.py, sparse
  linearization (the CUDA kernels), adaptive LM, 10 iterations; each
  request moves the initial poses' translations the same way.

It prints, per problem and batch, ms per call (mean of --reps calls after
one untimed call), solves per second and the mean final error, then one
JSON line of all rows, and the card's name and power limit. Run from the
root of a checkout:

    python3 scripts/torch_serving.py                     # on the card
    python3 scripts/torch_serving.py --batches 1 32 --suite ik
    python3 scripts/torch_serving.py --device cpu --batches 1 8 --reps 2

It imports neither jax nor theseus_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PGO_POSES = 16
PGO_ITERS = 10


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _time_calls(device, call, reps):
    """(mean ms, min ms, mean final error) of `reps` calls call(i), after
    one untimed call(-1); each call's error is read after its sync."""
    call(-1)
    _sync(device)
    times, errs = [], []
    for i in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        err = call(i)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        errs.append(float(err))
    return sum(times) / len(times), min(times), sum(errs) / len(errs)


def bench_ik(batches, reps, device):
    import torch

    from theseus_tpu_torch.utils.examples.inverse_kinematics import (
        build_ik_layer, ik_targets, perturb_targets)

    layer, fk, robot = build_ik_layer(torch.float32, device)
    rows = []
    for batch in batches:
        targets = ik_targets(fk, robot.dof, batch, torch.float32, device)
        theta0 = torch.zeros(batch, robot.dof, dtype=torch.float32, device=device)

        def call(i):
            _, info = layer.forward({"theta": theta0, "target": perturb_targets(targets, i)})
            return info.last_err.mean()

        ms, best, err = _time_calls(device, call, reps)
        rows.append({"problem": "ik7", "batch": batch, "ms_per_call": ms, "min_ms": best,
                     "solves_per_s": batch / ms * 1e3, "mean_final_err": err})
        print(f"ik7 batch={batch}: {ms:.3f} ms/call (min {best:.3f}), {batch / ms * 1e3:,.1f} solves/s, "
              f"mean_err={err:.3e}", flush=True)
    return rows


def bench_pgo(batches, reps, device):
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.inverse_kinematics import perturb_targets
    from theseus_tpu_torch.utils.examples.pose_graph import (
        build_pgo_objective, pose_values, synthetic_pose_graph)

    rows = []
    for batch in batches:
        gt, edges, meas, init = synthetic_pose_graph(PGO_POSES, batch, seed=0, dtype=torch.float32, device=device)
        obj, _ = build_pgo_objective(PGO_POSES, edges, meas, gt[0], dtype=torch.float32, device=device)
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=PGO_ITERS, adaptive_damping=True,
                                                      linearization="sparse"))

        def call(i):
            _, info = layer.forward(pose_values(perturb_targets(init, i)))
            return info.last_err.mean()

        ms, best, err = _time_calls(device, call, reps)
        rows.append({"problem": f"pgo{PGO_POSES}", "batch": batch, "ms_per_call": ms, "min_ms": best,
                     "solves_per_s": batch / ms * 1e3, "mean_final_err": err})
        print(f"pgo{PGO_POSES} batch={batch}: {ms:.3f} ms/call (min {best:.3f}), {batch / ms * 1e3:,.1f} solves/s, "
              f"mean_err={err:.3e}", flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32, 256, 1024, 4096])
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--suite", nargs="+", default=["ik", "pgo"], choices=["ik", "pgo"])
    p.add_argument("--device", default=None, help="default: the card (cpu runs the plain twins)")
    args = p.parse_args(argv)

    import torch

    from theseus_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        card = "cpu (not a device measurement)"
    print(f"device: {device} ({card}); torch {torch.__version__}", flush=True)
    rows = []
    if "ik" in args.suite:
        rows += bench_ik(args.batches, args.reps, device)
    if "pgo" in args.suite:
        rows += bench_pgo(args.batches, args.reps, device)
    print(json.dumps({"rows": rows, "device": str(device), "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
