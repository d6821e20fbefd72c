"""Learned-feature homography estimation (the port of examples/homography_learned.py).

A small CNN feature extractor is trained through the TheseusLayer so that
feature-metric LM alignment recovers the ground-truth homography on
photometrically distorted image pairs (easyaug's geometric and photometric
augmentations). The inner residual is an AutoDiffCostFunction whose
autograd mode (fwd or rev) is the ablation knob; --ablate runs both and
prints their losses and ms a step (the JAX script's --tpu has no
counterpart: the card is the default here). Pairs are made anew every step
from a torch.Generator seeded 0, the CNN from one seeded 1. Runs on the
card unless --device cpu is given.

    python examples_torch/homography_learned.py [--steps 30] [--batch 4] [--autograd-mode fwd|rev]
        [--patch-stride 4] [--channels 4] [--ablate] [--device cpu]
"""

import argparse
import math
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from examples_torch import _config
from theseus_tpu_torch.utils.examples.homography import HomographyTrainer
from theseus_tpu_torch.utils.timer import device_sync

H, W = 48, 64


def train(args, mode: str, verbose: bool = True):
    """(losses, seconds a step after the first, seconds of the first).
    args: steps, batch, patch_stride, channels, device, and height, width,
    seed where given (48, 64, 0 otherwise)."""
    h, w, seed = getattr(args, "height", H), getattr(args, "width", W), getattr(args, "seed", 0)
    device = torch.device(args.device) if args.device else None
    tr = HomographyTrainer(h, w, args.channels, args.patch_stride, mode, device=device,
                           generator=torch.Generator(device="cpu").manual_seed(seed + 1))
    gen = torch.Generator(device=tr.device).manual_seed(seed)
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--autograd-mode", default="fwd", choices=["fwd", "rev"])
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--patch-stride", type=int, default=4)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    for mode in ("fwd", "rev") if a.ablate else (a.autograd_mode,):
        losses, steady, first = train(a, mode, verbose=not a.ablate)
        print(f"{mode}: corner err first {losses[0]:.4f} -> best {min(losses):.4f} px, {steady * 1e3:.1f} ms a "
              f"step after the first ({first * 1e3:.1f} ms the first), batch {a.batch}, stride {a.patch_stride}")
        assert all(math.isfinite(x) for x in losses), "training diverged"
        if a.steps >= 5:
            # one or two Adam steps need not improve; at >= 5 they must
            assert min(losses) < losses[0], "training must reduce the corner error"


if __name__ == "__main__":
    main()
