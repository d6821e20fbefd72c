"""Homography estimation: the dense photometric fit and the learned-feature training task (JAX counterpart: examples/homography_estimation.py and examples/homography_learned.py).

The library half of the JAX package's two homography examples:

- `fit_photometric(img1, img2)` estimates the 8-parameter homography
  between image pairs by Levenberg-Marquardt on the per-pixel intensity
  residual over an interior patch, an `AutoDiffCostFunction` over bilinear
  sampling (`build_photometric` gives the layer and its inputs);
- `HomographyTrainer` trains a small CNN feature extractor THROUGH the
  `TheseusLayer`: a feature-metric `AutoDiffCostFunction` (its
  `autograd_mode` "fwd" or "rev" is the ablation), LM with adaptive
  damping, a backward truncated to the last 2 iterations, the mean corner
  error of the estimate as the loss and Adam on the CNN's weights. The
  pairs come from `make_pairs`: a smooth random image, a RandomGeoAug warp
  of it (the ground truth), and RandomPhotoAug distortions of both.

Image size, channels and the patch stride are arguments (the JAX example
holds them in module globals). Images are (B, H, W); the CNN runs in NCHW
and its features enter the cost channels-last, (B, H, W, C), as the
sampler takes them. Randomness comes from explicit torch.Generators.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ... import core
from ...config import resolve_device
from ...layer import TheseusLayer
from ...optim import LevenbergMarquardt
from ..warp import bilinear_sample, homography_transform, image_grid
from .easyaug import GeoAugParam, RandomGeoAug, RandomPhotoAug, draw_random

IDENTITY_H8 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
# the learned task's interior patch starts this many pixels inside the
# border, the photometric fit's this many
LEARNED_MARGIN = 6
PHOTOMETRIC_MARGIN = 8


def identity_h8(batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor(IDENTITY_H8, dtype=dtype, device=resolve_device(device)).repeat(batch, 1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def smooth_noise_shapes(h: int, w: int, octaves: int = 4):
    """The (hs, ws) of each octave's noise in `smooth_images`."""
    return [(max(2, h >> (octaves - o)), max(2, w >> (octaves - o))) for o in range(octaves)]


def smooth_images(b: int, h: int, w: int, octaves: int = 4, *, generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None, dtype=torch.float32, device=None):
    """(B, H, W) smooth random images in (0, 1]: per octave o, uniform noise
    (B, hs, ws) upsampled bilinearly (half-pixel centres, edge clamped, as
    jax.image.resize does) and weighted 1 / (o + 1), then each image
    divided by its maximum. noise: the octaves' draws (else drawn from
    `generator`)."""
    device = resolve_device(device)
    if noise is None:
        noise = [draw_random(False, (b,) + s, generator, dtype, device) for s in smooth_noise_shapes(h, w, octaves)]
    img = torch.zeros((b, h, w), dtype=dtype, device=device)
    for o, n in enumerate(noise):
        up = F.interpolate(n[:, None].to(dtype=dtype, device=device), size=(h, w), mode="bilinear",
                           align_corners=False)
        img = img + up[:, 0] / (o + 1)
    return img / torch.amax(img, dim=(1, 2), keepdim=True)


def pair_augmenters():
    """The learned task's RandomGeoAug (small perspective warps) and
    RandomPhotoAug (every op at probability 0.3, magnitude 0.3)."""
    geo = RandomGeoAug(
        scale_param=GeoAugParam(0.97, 1.03),
        rotate_param=GeoAugParam(-0.08, 0.08),
        translate_x_param=GeoAugParam(-0.03, 0.03),
        translate_y_param=GeoAugParam(-0.03, 0.03),
        perspective_param=GeoAugParam(-0.02, 0.02),
    )
    photo = RandomPhotoAug()
    photo.set_all_probs(0.3)
    photo.set_all_mags(0.3)
    return geo, photo


def make_pairs(batch: int, h: int = 48, w: int = 64, *, generator: Optional[torch.Generator] = None,
               dtype=torch.float32, device=None):
    """(img1, img2, h8_true (B, 8)): img2 is img1 warped by a RandomGeoAug
    homography, then both photometrically distorted."""
    img1 = smooth_images(batch, h, w, generator=generator, dtype=dtype, device=device)
    geo, photo = pair_augmenters()
    img2, mats = geo.forward(img1, generator, return_transform=True)
    img1 = photo.forward(img1, generator)
    img2 = photo.forward(img2, generator)
    return img1, img2, mats.reshape(batch, 9)[:, :8]


# ---------------------------------------------------------------------------
# the feature extractor
# ---------------------------------------------------------------------------


class CNN(torch.nn.Module):
    """Two 3x3 convolutions (1 -> 8 -> channels, padding 1), a ReLU between
    them, and an identity skip that adds the raw intensity to every output
    channel (the identity solution stays reachable at initialization); the
    features are scaled by 1 / sqrt(channels). Weights N(0, 0.5^2) from
    `generator`, biases 0. (B, H, W) -> (B, channels, H, W)."""

    def __init__(self, channels: int = 4, generator: Optional[torch.Generator] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.channels = channels
        self.conv1 = torch.nn.Conv2d(1, 8, 3, padding=1, dtype=dtype, device=device)
        self.conv2 = torch.nn.Conv2d(8, channels, 3, padding=1, dtype=dtype, device=device)
        with torch.no_grad():
            for conv in (self.conv1, self.conv2):
                conv.weight.copy_(0.5 * draw_random(True, conv.weight.shape, generator, dtype, device))
                conv.bias.zero_()

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        x = imgs[:, None]
        z = self.conv2(torch.relu(self.conv1(x))) + x
        return z / math.sqrt(self.channels)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def patch_points(h: int, w: int, stride: int = 4, margin: int = LEARNED_MARGIN, dtype=torch.float32, device=None):
    """The residual's points: the interior grid `margin` pixels in from the
    border, every `stride`-th point in row-major order. (Np, 2)."""
    grid = image_grid(h - 2 * margin, w - 2 * margin, dtype=dtype, device=resolve_device(device)) + float(margin)
    return grid[::stride]


def build_layer(h: int = 48, w: int = 64, channels: int = 4, patch_stride: int = 4, autograd_mode: str = "fwd",
                max_iterations: int = 12, dtype=torch.float32, device=None):
    """(layer, objective, patch): one feature-metric AutoDiffCostFunction
    over the homography "h8" with aux "feat1" (H, W, C) and "feat2_patch"
    (Np, C) per batch element: feat1 sampled at H(h8) patch minus
    feat2_patch, (Np * C,). LM with adaptive damping."""
    device = resolve_device(device)
    patch = patch_points(h, w, patch_stride, dtype=dtype, device=device)
    n_pts = patch.shape[0]
    h8 = core.Vector(8, name="h8")
    f1 = core.Variable(torch.zeros((1, h, w, channels), dtype=dtype, device=device), name="feat1")
    f2p = core.Variable(torch.zeros((1, n_pts, channels), dtype=dtype, device=device), name="feat2_patch")

    def err_fn(optim, aux):
        (hv,) = optim
        feat1, ftgt = aux  # (H, W, C), (Np, C)
        return (bilinear_sample(feat1, homography_transform(hv, patch)) - ftgt).reshape(-1)

    obj = core.Objective(dtype=dtype, device=device)
    obj.add(core.AutoDiffCostFunction([h8], n_pts * channels, err_fn, aux_vars=[f1, f2p], name="featmetric",
                                      autograd_mode=autograd_mode))
    opt = LevenbergMarquardt(obj, max_iterations=max_iterations, adaptive_damping=True)
    return TheseusLayer(opt), obj, patch


def corner_points(h: int, w: int, margin: int = LEARNED_MARGIN, dtype=torch.float32, device=None):
    m = float(margin)
    return torch.tensor([[m, m], [w - 1 - m, m], [m, h - 1 - m], [w - 1 - m, h - 1 - m]], dtype=dtype,
                        device=resolve_device(device))


def corner_error(h8_est: torch.Tensor, h8_true: torch.Tensor, h: int = 48, w: int = 64) -> torch.Tensor:
    """Mean distance in pixels between the patch corners moved by the two
    homographies."""
    c = corner_points(h, w, dtype=h8_est.dtype, device=h8_est.device)[None]
    pe = homography_transform(h8_est[:, None, :], c)
    pt = homography_transform(h8_true[:, None, :].to(h8_est.dtype), c)
    return torch.mean(torch.linalg.vector_norm(pe - pt, dim=-1))


def channels_last(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C)."""
    return feat.permute(0, 2, 3, 1)


class HomographyTrainer:
    """The CNN trained through the layer: `loss(img1, img2, h8_true)` is the
    corner error of LM's estimate from identity, with the backward
    truncated to the last `backward_iterations` LM iterations; `step` adds
    Adam (lr 2e-3 by default) on the CNN's weights."""

    def __init__(self, h: int = 48, w: int = 64, channels: int = 4, patch_stride: int = 4,
                 autograd_mode: str = "fwd", max_iterations: int = 12, backward_iterations: int = 2,
                 lr: float = 2e-3, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None,
                 cnn: Optional[CNN] = None):
        self.device = resolve_device(device)
        self.h, self.w, self.dtype = h, w, dtype
        self.backward_iterations = backward_iterations
        self.cnn = cnn if cnn is not None else CNN(channels, generator, dtype, self.device)
        self.layer, self.objective, self.patch = build_layer(h, w, channels, patch_stride, autograd_mode,
                                                             max_iterations, dtype, self.device)
        self.optimizer = torch.optim.Adam(self.cnn.parameters(), lr=lr)

    def estimate(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """The LM estimate h8 (B, 8) on the CNN's features, differentiable
        (truncated) in the CNN's weights."""
        b = img1.shape[0]
        feat1 = channels_last(self.cnn(img1))
        feat2 = channels_last(self.cnn(img2))
        f2p = torch.func.vmap(bilinear_sample, in_dims=(0, None))(feat2, self.patch)
        co = self.objective.compile()
        values = {"h8": identity_h8(b, self.dtype, self.device), "feat1": feat1, "feat2_patch": f2p}
        state, aux = co.pack(values, b), co.build_aux(values, b)
        carry = self.layer.solve_state(state, aux, "truncated", self.layer.optimizer.opts, self.backward_iterations)
        return co.unpack(carry["state"])["h8"]

    def loss(self, img1: torch.Tensor, img2: torch.Tensor, h8_true: torch.Tensor) -> torch.Tensor:
        return corner_error(self.estimate(img1, img2), h8_true, self.h, self.w)

    def step(self, img1: torch.Tensor, img2: torch.Tensor, h8_true: torch.Tensor) -> torch.Tensor:
        """One Adam step; returns the step's loss (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(img1, img2, h8_true)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self, steps: int, batch: int, generator: torch.Generator) -> List[float]:
        """`steps` Adam steps, each on fresh pairs from `make_pairs`; the
        losses."""
        losses = []
        for _ in range(steps):
            img1, img2, h8_true = make_pairs(batch, self.h, self.w, generator=generator, dtype=self.dtype,
                                             device=self.device)
            losses.append(float(self.step(img1, img2, h8_true)))
        return losses


# ---------------------------------------------------------------------------
# the dense photometric fit
# ---------------------------------------------------------------------------


def build_photometric(img1: torch.Tensor, img2: torch.Tensor, max_iterations: int = 60,
                      init: Optional[torch.Tensor] = None, margin: int = PHOTOMETRIC_MARGIN):
    """(layer, inputs) of the dense fit of img2 -> img1 (B, H, W): the
    intensity residual img1(H(h8) p) - img2(p) over the interior grid
    `margin` pixels in, an AutoDiffCostFunction over "h8" with aux "img1"
    and "target". LM with adaptive damping, on img1's device and dtype."""
    b, h, w = img1.shape
    dtype, device = img1.dtype, img1.device
    patch = image_grid(h - 2 * margin, w - 2 * margin, dtype=dtype, device=device) + float(margin)
    target = torch.func.vmap(bilinear_sample, in_dims=(0, None))(img2, patch)
    h8 = core.Vector(8, name="h8")
    img_var = core.Variable(img1, name="img1")
    tgt_var = core.Variable(target, name="target")

    def err_fn(optim, aux):
        (hv,) = optim
        img, tgt = aux
        return bilinear_sample(img, homography_transform(hv, patch)) - tgt

    obj = core.Objective(dtype=dtype, device=device)
    obj.add(core.AutoDiffCostFunction([h8], patch.shape[0], err_fn, aux_vars=[img_var, tgt_var], name="photo"))
    layer = TheseusLayer(LevenbergMarquardt(obj, max_iterations=max_iterations, adaptive_damping=True))
    return layer, {"h8": identity_h8(b, dtype, device) if init is None else init}


def fit_photometric(img1: torch.Tensor, img2: torch.Tensor, max_iterations: int = 60,
                    init: Optional[torch.Tensor] = None, optimizer_kwargs: Optional[Dict] = None):
    """(h8 (B, 8), info): the LM estimate of the homography taking img2's
    patch into img1."""
    layer, inputs = build_photometric(img1, img2, max_iterations, init)
    values, info = layer.forward(inputs, optimizer_kwargs=optimizer_kwargs)
    return values["h8"], info
