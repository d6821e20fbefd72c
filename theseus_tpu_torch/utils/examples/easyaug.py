"""Random geometric and photometric augmentation for direct-alignment training (JAX counterpart: theseus_tpu/utils/examples/easyaug.py).

Images are (B, H, W) or (B, C, H, W) floats in [0, 1]. Every augmentation
is split in two: a method that makes the random draws from a
`torch.Generator` (`draw`), and a pure function of those draws (the op
functions, `RandomGeoAug.transforms`, `RandomPhotoAug.apply`). `forward`
composes them; passing `draws=` instead of a generator replays given draws
(the tests feed the JAX package's, drawn from its key chain). A batch
element's draws are shared by its channels, as the JAX package's key is.

The per-op gates are branchless (`torch.where`): a data-dependent `if`
would wait for the card. The JAX package's `jnp.convolve` blurs (box,
Gaussian) become separable `conv2d` passes with replicate padding, and its
`lax.conv_general_dilated` motion blur a `conv2d`, which is a correlation
as that one is. A convolution flips its kernel and a correlation does not;
all three kernels are symmetric (the 1-D ones about their centre, the
motion kernel under a half turn), so the flips do not matter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ...config import resolve_device
from ..warp import bilinear_sample, homography_transform, image_grid


def draw_random(normal: bool, shape, generator, dtype, device) -> torch.Tensor:
    """torch.randn (normal) or torch.rand from `generator`, drawn on the
    generator's own device (the same numbers wherever they go), then moved
    to `device`: the given one, else the generator's, else the card."""
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    src = generator.device if generator is not None else device
    fn = torch.randn if normal else torch.rand
    return fn(shape, generator=generator, dtype=dtype, device=src).to(device)


def _uniform(shape, lo, hi, generator, dtype, device) -> torch.Tensor:
    return lo + (hi - lo) * draw_random(False, shape, generator, dtype, device)


# ---------------------------------------------------------------------------
# low-level helpers
# ---------------------------------------------------------------------------


def _corners(h: int, w: int, dtype, device) -> torch.Tensor:
    return torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]], dtype=dtype,
                        device=device)


def homography_from_corners(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """DLT solve for the 8-parameter homography mapping the 4 src points to
    dst: src, dst (..., 4, 2) -> h8 (..., 8)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    ru = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)  # (..., 4, 8)
    rv = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    rows = torch.stack([ru, rv], dim=-2).reshape(ru.shape[:-2] + (8, 8))  # u0, v0, u1, v1, ...
    rhs = torch.stack([u, v], dim=-1).reshape(u.shape[:-1] + (8,))
    return torch.linalg.solve(rows, rhs)


def random_homography(h: int, w: int, perturb: float = 0.1, *, jitter: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None, dtype=torch.float32, device=None):
    """The 8-parameter homography that moves the image corners by
    perturb * min(h, w) * jitter, jitter (..., 4, 2) uniform in [-1, 1]
    (drawn from `generator` when not given). Returns h8 (..., 8)."""
    if jitter is None:
        jitter = _uniform((4, 2), -1.0, 1.0, generator, dtype, device)
    corners = _corners(h, w, jitter.dtype, jitter.device)
    return homography_from_corners(corners.expand(jitter.shape), corners + perturb * min(h, w) * jitter)


def warp_image(img: torch.Tensor, h8: torch.Tensor) -> torch.Tensor:
    """img (H, W) warped by h8 (8,): the value at pixel p is img sampled at
    H(h8) p, border clamped."""
    h, w = img.shape[-2:]
    grid = image_grid(h, w, dtype=img.dtype, device=img.device)
    return bilinear_sample(img, homography_transform(h8, grid)).reshape(img.shape)


def warp_images(imgs: torch.Tensor, h8s: torch.Tensor) -> torch.Tensor:
    """(B, [C,] H, W) images, each warped by its h8 (B, 8)."""
    if imgs.dim() == 3:
        return torch.func.vmap(warp_image)(imgs, h8s)
    return torch.func.vmap(torch.func.vmap(warp_image, in_dims=(0, None)))(imgs, h8s)


def geo_aug(img: torch.Tensor, perturb: float = 0.08, *, jitter=None, generator=None):
    """Warp an image (H, W) by a random homography; returns (warped, h8)."""
    h, w = img.shape[-2:]
    h8 = random_homography(h, w, perturb, jitter=jitter, generator=generator, dtype=img.dtype, device=img.device)
    return warp_image(img, h8), h8


def photo_aug(img: torch.Tensor, brightness=0.2, contrast=0.2, gamma=0.2, noise=0.02, *,
              draws: Optional[Dict[str, torch.Tensor]] = None, generator=None):
    """Random brightness, contrast, gamma and additive noise, values kept in
    [0, 1]. draws: "brightness", "contrast", "gamma" (uniform in [-1, 1])
    and "noise" (standard normal, img's shape)."""
    if draws is None:
        dt, dev = img.dtype, img.device
        draws = {k: _uniform((), -1.0, 1.0, generator, dt, dev) for k in ("brightness", "contrast", "gamma")}
        draws["noise"] = draw_random(True, img.shape, generator, dt, dev)
    b = brightness * draws["brightness"]
    c = 1.0 + contrast * draws["contrast"]
    g = torch.exp(gamma * draws["gamma"])
    out = torch.clamp(c * img + b, 1e-4, 1.0) ** g
    out = out + noise * draws["noise"]
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# RandomGeoAug
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeoAugParam:
    """min/max range of one geometric factor."""

    min: float = 0.0
    max: float = 0.0

    def sample(self, shape=(), generator=None, dtype=torch.float32, device=None) -> torch.Tensor:
        return _uniform(shape, self.min, self.max, generator, dtype, device)


GEO_FACTORS = ("scale", "rotate", "translate_x", "translate_y", "perspective")


@dataclasses.dataclass
class RandomGeoAug:
    """Random perspective transform per batch element: scale, rotation
    (radians), x/y translation (fractions of W and H) and a perspective
    corner jitter (fraction of W and H), composed into one homography.

    `forward(imgs, generator, return_transform=False)` warps (B, [C,] H, W)
    images and optionally returns the (B, 3, 3) pixel-space transforms."""

    scale_param: GeoAugParam = dataclasses.field(default_factory=lambda: GeoAugParam(0.9, 1.1))
    rotate_param: GeoAugParam = dataclasses.field(default_factory=lambda: GeoAugParam(-0.25, 0.25))
    translate_x_param: GeoAugParam = dataclasses.field(default_factory=lambda: GeoAugParam(-0.1, 0.1))
    translate_y_param: GeoAugParam = dataclasses.field(default_factory=lambda: GeoAugParam(-0.1, 0.1))
    perspective_param: GeoAugParam = dataclasses.field(default_factory=lambda: GeoAugParam(-0.1, 0.1))

    def set_all_identity(self):
        """Zero all ranges."""
        self.scale_param = GeoAugParam(1.0, 1.0)
        self.rotate_param = GeoAugParam(0.0, 0.0)
        self.translate_x_param = GeoAugParam(0.0, 0.0)
        self.translate_y_param = GeoAugParam(0.0, 0.0)
        self.perspective_param = GeoAugParam(0.0, 0.0)

    def draw(self, b: int, generator=None, dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
        """Per batch element, each factor uniform in its range: (B,), and
        "perspective" (B, 4, 2)."""
        out = {}
        for f in GEO_FACTORS:
            shape = (b, 4, 2) if f == "perspective" else (b,)
            out[f] = getattr(self, f + "_param").sample(shape, generator, dtype, device)
        return out

    @staticmethod
    def transforms(draws: Dict[str, torch.Tensor], h: int, w: int) -> torch.Tensor:
        """h8 (B, 8) from the draws: rotation and scale about the image
        centre, then the translation, then the corner jitter."""
        s, th = draws["scale"], draws["rotate"]
        dtype, device = s.dtype, s.device
        tx, ty = w * draws["translate_x"], h * draws["translate_y"]
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        c, si = (torch.cos(th) * s)[:, None], (torch.sin(th) * s)[:, None]
        corners = _corners(h, w, dtype, device)
        rel = corners - torch.tensor([cx, cy], dtype=dtype, device=device)
        rot = torch.stack([c * rel[:, 0] - si * rel[:, 1], si * rel[:, 0] + c * rel[:, 1]], dim=-1)
        dst = rot + torch.stack([cx + tx, cy + ty], dim=-1)[:, None, :]
        dst = dst + draws["perspective"] * torch.tensor([w, h], dtype=dtype, device=device)
        return homography_from_corners(corners.expand(dst.shape), dst)

    def forward(self, imgs: torch.Tensor, generator=None, return_transform: bool = False, draws=None):
        b = imgs.shape[0]
        h, w = imgs.shape[-2:]
        if draws is None:
            draws = self.draw(b, generator, imgs.dtype, imgs.device)
        h8s = self.transforms(draws, h, w).to(imgs.dtype)
        out = warp_images(imgs, h8s)
        if not return_transform:
            return out
        mats = torch.cat([h8s, torch.ones((b, 1), dtype=imgs.dtype, device=imgs.device)], dim=-1)
        return out, mats.reshape(b, 3, 3)

    __call__ = forward


# ---------------------------------------------------------------------------
# RandomPhotoAug
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhotoAugParam:
    """Probability and magnitude of one photometric op."""

    prob: float = 0.5
    mag: float = 0.5


PHOTO_OPS = (
    "contrast",
    "sharpen",
    "exposure",
    "gamma",
    "gaussian_smooth",
    "motion_blur",
    "shadow_highlight",
    "gaussian_noise",
    "salt_and_pepper",
)

# per op, its draws: name -> (kind, low, high); kind "u" a scalar per batch
# element uniform in [low, high), "U" / "N" a uniform / normal field of
# the plane's shape
_OP_DRAWS = {
    "contrast": {"u": ("u", -1.0, 1.0)},
    "sharpen": {"u": ("u", 0.0, 1.0)},
    "exposure": {"u": ("u", -1.0, 1.0)},
    "gamma": {"u": ("u", -1.0, 1.0)},
    "gaussian_smooth": {"u": ("u", 0.0, 1.0)},
    "motion_blur": {"theta": ("u", 0.0, math.pi), "u": ("u", 0.0, 1.0)},
    "shadow_highlight": {"u_lo": ("u", 0.0, 1.0), "u_hi": ("u", 0.0, 1.0)},
    "gaussian_noise": {"n": ("N", 0.0, 1.0)},
    "salt_and_pepper": {"u": ("U", 0.0, 1.0), "salt": ("U", 0.0, 1.0)},
}


def _per_plane(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """A per-batch-element scalar (B,) against img (B, [C,] H, W)."""
    return x.reshape(x.shape + (1,) * (img.dim() - 1))


def _field(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """A per-batch-element field (B, H, W) against img (B, [C,] H, W)."""
    return x if img.dim() == 3 else x[:, None]


def _planes(img: torch.Tensor):
    """img (B, [C,] H, W) -> (1, B*C, H, W) for a grouped conv2d, and the
    channels per batch element."""
    c = 1 if img.dim() == 3 else img.shape[1]
    return img.reshape((1, -1) + tuple(img.shape[-2:])), c


def _sep_conv(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable filter with edge (replicate) padding: columns, then rows.
    kern (B, k): one 1-D kernel per batch element, shared by its channels."""
    x, c = _planes(img)
    r = kern.shape[-1] // 2
    k = kern.repeat_interleave(c, dim=0)  # (B*C, k)
    groups = x.shape[1]
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), k[:, None, :, None], groups=groups)
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), k[:, None, None, :], groups=groups)
    return x.reshape(img.shape)


def _box_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    k = 2 * radius + 1
    kern = torch.full((img.shape[0], k), 1.0 / k, dtype=img.dtype, device=img.device)
    return _sep_conv(img, kern)


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """sigma (B,)."""
    xs = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    kern = torch.exp(-0.5 * (xs / sigma[:, None]) ** 2)
    return _sep_conv(img, kern / torch.sum(kern, dim=-1, keepdim=True))


def _motion_blur(img: torch.Tensor, theta: torch.Tensor, length: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """A soft line kernel along theta (B,) with extent length (B,)."""
    xs = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")  # gx varies along a row
    ct, st = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    d_along = gx * ct + gy * st
    d_perp = -gx * st + gy * ct
    kern = torch.exp(-0.5 * (d_perp / 0.5) ** 2) * (torch.abs(d_along) <= length[:, None, None] / 2.0)
    kern = kern / torch.clamp(torch.sum(kern, dim=(-2, -1), keepdim=True), min=1e-6)
    x, c = _planes(img)
    x = F.pad(x, (radius,) * 4, mode="replicate")
    out = F.conv2d(x, kern.repeat_interleave(c, dim=0)[:, None], groups=x.shape[1])
    return out.reshape(img.shape)


def contrast(img, mag, u):
    f = _per_plane(1.0 + mag * u, img)
    m = torch.mean(img, dim=(-2, -1), keepdim=True)
    return (img - m) * f + m


def sharpen(img, mag, u):
    return img + _per_plane(mag * u, img) * (img - _box_blur(img, 1))


def exposure(img, mag, u):
    return img * _per_plane(2.0 ** (mag * u), img)


def gamma(img, mag, u):
    return torch.clamp(img, 1e-4, 1.0) ** _per_plane(torch.exp(mag * u), img)


def gaussian_smooth(img, mag, u):
    return _gaussian_blur(img, 0.3 + mag * u * 1.7)


def motion_blur(img, mag, theta, u):
    return _motion_blur(img, theta, 1.0 + mag * u * 6.0)


def shadow_highlight(img, mag, u_lo, u_hi):
    lo = _per_plane(mag * 0.3 * u_lo, img)
    hi = _per_plane(1.0 - mag * 0.3 * u_hi, img)
    return torch.clamp((img - lo) / torch.clamp(hi - lo, min=1e-3), 0.0, 1.0)


def gaussian_noise(img, mag, n):
    return img + 0.08 * mag * _field(n, img)


def salt_and_pepper(img, mag, u, salt):
    pepper_or_salt = (_field(salt, img) > 0.5).to(img.dtype)
    return torch.where(_field(u, img) < 0.02 * mag, pepper_or_salt, img)


_OPS = {
    "contrast": contrast,
    "sharpen": sharpen,
    "exposure": exposure,
    "gamma": gamma,
    "gaussian_smooth": gaussian_smooth,
    "motion_blur": motion_blur,
    "shadow_highlight": shadow_highlight,
    "gaussian_noise": gaussian_noise,
    "salt_and_pepper": salt_and_pepper,
}


@dataclasses.dataclass
class RandomPhotoAug:
    """The nine-op photometric pipeline (contrast, sharpen, exposure,
    gamma, Gaussian smoothing, motion blur, shadow/highlight, Gaussian
    noise, salt and pepper), each op applied in that order with its own
    probability and magnitude, gated per batch element."""

    params: dict = dataclasses.field(default_factory=lambda: {op: PhotoAugParam() for op in PHOTO_OPS})

    def set_all_probs(self, val: float):
        for p in self.params.values():
            p.prob = val

    def set_all_mags(self, val: float):
        for p in self.params.values():
            p.mag = val

    @staticmethod
    def draw(b: int, h: int, w: int, generator=None, dtype=torch.float32, device=None) -> Dict[str, Dict]:
        """{op: {"gate": (B,) uniform in [0, 1), and the op's draws}}."""
        out = {}
        for op in PHOTO_OPS:
            d = {"gate": _uniform((b,), 0.0, 1.0, generator, dtype, device)}
            for name, (kind, lo, hi) in _OP_DRAWS[op].items():
                if kind == "N":
                    d[name] = draw_random(True, (b, h, w), generator, dtype, device)
                else:
                    d[name] = _uniform((b,) if kind == "u" else (b, h, w), lo, hi, generator, dtype, device)
            out[op] = d
        return out

    def apply(self, imgs: torch.Tensor, draws: Dict[str, Dict]) -> torch.Tensor:
        """The pipeline on (B, [C,] H, W) at the given draws."""
        out = imgs
        for op in PHOTO_OPS:
            p = self.params[op]
            d = dict(draws[op])
            gate = _per_plane(d.pop("gate") < p.prob, out)
            cand = _OPS[op](out, p.mag, **d)
            out = torch.where(gate, torch.clamp(cand, 0.0, 1.0), out)
        return out

    def forward(self, imgs: torch.Tensor, generator=None, draws=None) -> torch.Tensor:
        if draws is None:
            draws = self.draw(imgs.shape[0], imgs.shape[-2], imgs.shape[-1], generator, imgs.dtype, imgs.device)
        return self.apply(imgs, draws)

    __call__ = forward
