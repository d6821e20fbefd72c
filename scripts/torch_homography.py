#!/usr/bin/env python3
"""Train the learned-feature homography task of theseus_tpu_torch (the port of examples/homography_learned.py).

A small CNN is trained THROUGH the TheseusLayer: LM on a feature-metric
AutoDiffCostFunction from identity, a backward truncated to the last 2
iterations, the mean corner error as the loss, Adam. The pairs are made
anew every step from a torch.Generator seeded by --seed
(utils/examples/homography.py `make_pairs`). Runs on the card unless
--device cpu is given.

    python3 scripts/torch_homography.py [--steps 30] [--batch 4] [--autograd-mode fwd|rev]
        [--patch-stride 4] [--channels 4] [--height 48] [--width 64] [--device cpu] [--ablate]
        [--config examples/configs/homography_learned.yaml]

--config reads a flat YAML file whose keys override the defaults (explicit
flags still win) through examples_torch/_config.py, which needs no YAML
package. --ablate runs both autograd modes and prints their first and best
losses and ms a step. The training loop is examples_torch/homography_learned.py's
`train`; this script adds --height, --width and --seed.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from examples_torch._config import parse_with_config  # noqa: E402
from examples_torch.homography_learned import train  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--autograd-mode", default="fwd", choices=["fwd", "rev"])
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--patch-stride", type=int, default=4)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = parse_with_config(p, argv)

    for mode in ("fwd", "rev") if args.ablate else (args.autograd_mode,):
        losses, steady, first = train(args, mode, verbose=not args.ablate)
        print(f"{mode}: corner err first {losses[0]:.4f} -> best {min(losses):.4f} px, {steady * 1e3:.1f} ms a "
              f"step after the first ({first * 1e3:.1f} ms the first), batch {args.batch}, "
              f"{args.height}x{args.width}, stride {args.patch_stride}")
        if not all(math.isfinite(x) for x in losses):
            print("training diverged", file=sys.stderr)
            return 1
        if args.steps >= 5 and not min(losses) < losses[0]:
            print("training did not reduce the corner error", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
