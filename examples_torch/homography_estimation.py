"""Dense photometric homography estimation (the port of examples/homography_estimation.py).

Estimate the 8-dof homography between an image and its warp by minimizing
the per-pixel intensity residual over an interior patch with LM; the
residual is an AutoDiffCostFunction over bilinear sampling. The image is
smooth noise drawn from a CPU torch.Generator seeded by --seed. Runs on
the card unless --device cpu is given.

    python examples_torch/homography_estimation.py [--height 60] [--width 80] [--max-iterations 60] [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.homography import fit_photometric, smooth_images
from theseus_tpu_torch.utils.warp import bilinear_sample, homography_transform, image_grid

H_TRUE = (1.02, 0.01, 1.5, -0.02, 0.98, -1.0, 1e-4, -5e-5)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=60)
    p.add_argument("--width", type=int, default=80)
    p.add_argument("--max-iterations", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    dev = config.resolve_device(args.device)

    h, w = args.height, args.width
    img1 = smooth_images(1, h, w, generator=torch.Generator().manual_seed(args.seed), device=dev)
    h_true = torch.tensor(H_TRUE, device=dev)
    grid = image_grid(h, w, device=dev)
    img2 = bilinear_sample(img1[0], homography_transform(h_true, grid)).reshape(1, h, w)

    # the homography from img2 to img1 over the interior patch
    est, info = fit_photometric(img1, img2, args.max_iterations)
    print("true h8:", h_true.cpu().numpy())
    print("est  h8:", est[0].cpu().numpy())
    print("final photometric err:", float(info.last_err[0]))
    assert float((est[0] - h_true).abs().max()) < 0.2


if __name__ == "__main__":
    main()
