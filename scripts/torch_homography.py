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

--config reads a YAML file whose keys override the defaults (explicit
flags still win), as the JAX examples do; it needs PyYAML. --ablate runs
both autograd modes and prints their first and best losses and ms a step.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def parse_with_config(parser: argparse.ArgumentParser, argv=None):
    """parser.parse_args with a --config YAML file whose keys (dashes or
    underscores) override the defaults; explicit flags still win. An
    unknown key raises SystemExit."""
    parser.add_argument("--config", default=None,
                        help="YAML file whose keys override the defaults; explicit flags still win")
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        import yaml

        with open(pre.config) as f:
            cfg = yaml.safe_load(f) or {}
        known = {a.dest for a in parser._actions}
        overrides = {}
        for k, v in cfg.items():
            dest = k.replace("-", "_")
            if dest not in known:
                raise SystemExit(f"config key {k!r} does not match any option (known: {sorted(known)})")
            overrides[dest] = v
        parser.set_defaults(**overrides)
    return parser.parse_args(argv)


def train(args, mode: str, verbose: bool = True):
    """(losses, seconds a step after the first, seconds of the first)."""
    import torch

    from theseus_tpu_torch.utils.examples.homography import HomographyTrainer
    from theseus_tpu_torch.utils.timer import device_sync

    device = torch.device(args.device) if args.device else None
    tr = HomographyTrainer(args.height, args.width, args.channels, args.patch_stride, mode, device=device,
                           generator=torch.Generator(device="cpu").manual_seed(args.seed + 1))
    gen = torch.Generator(device=tr.device).manual_seed(args.seed)
    losses, times = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        losses += tr.train(1, args.batch, gen)
        device_sync(tr.device)
        times.append(time.perf_counter() - t0)
        if verbose and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i:3d}  corner err {losses[-1]:.4f} px  {times[-1] * 1e3:.1f} ms", flush=True)
    steady = sum(times[1:]) / max(len(times) - 1, 1)
    return losses, steady, times[0]


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
