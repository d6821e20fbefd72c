#!/usr/bin/env python3
"""How far apart the vectorization ablation's arms land: the final LM error of PGO under compile(vectorize=False) with the plain twins, vectorize=True with the twins and vectorize=True with the kernels, after 10, 34 and 60 iterations, float32 and float64.

The numbers behind the evaluations phase's tolerances (chip_smoke.py
`EVAL_VEC_RTOL`, `PLATEAU_RTOL_F32`): the largest relative deviation of
one batch element's final error, and of the batch mean, from the
unvectorized arm's. On the CPU the kernel arm is the twins again. Runs on
the card unless --device cpu is given.

    python3 scripts/torch_vectorize_arms.py [--poses 16] [--batch 16] [--device cpu]
"""

import argparse
import contextlib
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from evaluations_torch import _common
from evaluations_torch.vectorization_ablation import ALL_COMBOS, build, lm_solver
from theseus_tpu_torch import config

ITERS = (10, 34, 60)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--poses", type=int, default=16)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    print(_common.card_line(dev))
    for dtype in (torch.float32, torch.float64):
        errs = {}
        for name, (vec, kernels) in ALL_COMBOS.items():
            with contextlib.nullcontext() if kernels else config.plain_path():
                solve = lm_solver(*build(a.poses, a.batch, vec, dtype, dev))
                errs[name] = [solve(n).double().cpu() for n in ITERS]
        ref = errs["off"]
        for name in ("on", "on+kernels"):
            for n, e, r in zip(ITERS, errs[name], ref):
                elem = float(((e - r).abs() / r.abs()).max())
                mean = abs(float(e.mean() / r.mean()) - 1.0)
                print(f"{config.dtype_name(dtype)} {a.poses}x{a.batch} {name} vs off after {n} iterations: "
                      f"element {elem:.3e}, batch mean {mean:.3e} (mean error {float(r.mean()):.9e})")


if __name__ == "__main__":
    main()
