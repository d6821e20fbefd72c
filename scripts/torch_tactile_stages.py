#!/usr/bin/env python3
"""Where the tactile LM iteration's host time goes: ms of each cost bucket's linearization and error, in float32 and float64.

The tactile objective of chip_smoke.py's `tactile` phase (100 steps,
moving-frame windows 10..40 step 5, batch 64, the ground-truth moving-frame
measurements, weights 1) on the sparse linearization. For each bucket
(the prior, the quasi-static pushing and contact costs, whose jacobians are
vmapped forward-mode autodiff, the moving-frame Betweens and the
motion-capture priors) it prints the ms of one linearization and one error
evaluation (each synced, the mean of --reps calls after one warm call), in
float32 and float64: forward-mode jacobians below float64 run in float64
(core/cost_function.py), so the float32 line against the float64 line
shows what that costs. Then the whole linearization and error metric.

    python3 scripts/torch_tactile_stages.py [--device cpu] [--steps 100] [--batch 64] [--reps 5]

Like every entry point it runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def synced_ms(fn, reps, device):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--reps", type=int, default=5)
    a = p.parse_args()

    import functools

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.config import resolve_device
    from theseus_tpu_torch.models import tactile

    device = resolve_device(a.device)
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(f"[card] {card}")
    for dtype in (torch.float32, torch.float64):
        est = tactile.TactilePoseEstimator(a.steps, 10, 40, 5, dtype=dtype, device=device,
                                           optimizer_cls=functools.partial(tt.LevenbergMarquardt,
                                                                           linearization="sparse"))
        base, obj_gt, eff_gt, _ = tactile.synthetic_push(est, batch=a.batch, seed=0)
        values = est.objective.default_values(dict(base, **tactile.relative_measurements(est, obj_gt, eff_gt)))
        co = est.objective.compile()
        state, aux = co.pack(values, a.batch), co.build_aux(values, a.batch)
        name = str(dtype)[6:]
        with torch.no_grad():
            for bk, bk_aux in zip(co.buckets, aux):
                lin = synced_ms(lambda: co._bucket_eval(bk, state, bk_aux, "linearize"), a.reps, device)
                err = synced_ms(lambda: co._bucket_eval(bk, state, bk_aux, "metric"), a.reps, device)
                print(f"[tactile-stages] {name} {bk.name:<40} K={bk.k:<4} linearize {lin:8.3f} ms, error {err:7.3f} ms")
            lin = synced_ms(lambda: co.linearize_blocks(state, aux), a.reps, device)
            err = synced_ms(lambda: co.error_metric(state, aux), a.reps, device)
            print(f"[tactile-stages] {name} all buckets: linearize {lin:.3f} ms, error metric {err:.3f} ms "
                  f"(T={a.steps}, B={a.batch}, {device.type})")


if __name__ == "__main__":
    main()
