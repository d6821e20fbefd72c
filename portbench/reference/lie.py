"""Plain SO3 and SE3 maps in PyTorch, for the benchmark's generators and its
reference solvers.

Written from the textbook formulas (Sola et al., "A micro Lie theory",
2018): an SE3 element is a (..., 3, 4) matrix [R | t], a tangent vector is
(..., 6) with the translation part first, and x + d is x exp(d). Every
division has a guarded denominator and every small-angle case a Taylor
branch, so forward-mode derivatives are finite at the identity. Nothing
here imports the program under test.
"""

from __future__ import annotations

import torch

_SMALL = 1e-4  # angle below which the Taylor branches are used


def hat(w):
    """(..., 3) -> (..., 3, 3) skew matrix."""
    z = torch.zeros_like(w[..., 0])
    x, y, c = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([torch.stack([z, -c, y], -1), torch.stack([c, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def _coeffs(w):
    """theta^2 and the three Rodrigues coefficients sin/t, (1-cos)/t^2,
    (t-sin)/t^3 of rotation vectors w (..., 3)."""
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < _SMALL * _SMALL
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    return a, b, c


def exp(x):
    """se(3) (..., 6) -> SE(3) (..., 3, 4)."""
    v, w = x[..., :3], x[..., 3:]
    a, b, c = _coeffs(w)
    wh = hat(w)
    wh2 = wh @ wh
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    r = eye + a[..., None, None] * wh + b[..., None, None] * wh2
    vm = eye + b[..., None, None] * wh + c[..., None, None] * wh2
    return torch.cat([r, (vm @ v[..., None])], dim=-1)


def so3_log(r):
    """SO(3) (..., 3, 3) -> rotation vector (..., 3), for angles below pi."""
    s = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                           r[..., 1, 0] - r[..., 0, 1]], -1)
    cos = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0)
    n2 = torch.sum(s * s, dim=-1)
    small = (n2 < _SMALL * _SMALL) & (cos > 0)
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    # theta / sin(theta), sin(theta) = n; the angle from atan2 keeps its digits
    # where cos alone would not
    f = torch.where(small, 1.0 + n2 / 6.0, torch.atan2(n, cos) / n)
    return f[..., None] * s


def log(g):
    """SE(3) (..., 3, 4) -> se(3) (..., 6)."""
    w = so3_log(g[..., :3])
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < _SMALL * _SMALL
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    # V^-1 = I - w^/2 + d w^2, d = (1 - t sin t / (2 (1 - cos t))) / t^2
    d = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    (1.0 - t * torch.sin(t) / (2.0 * (1.0 - torch.cos(t)))) / t2s)
    wh = hat(w)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    vinv = eye - 0.5 * wh + d[..., None, None] * (wh @ wh)
    return torch.cat([(vinv @ g[..., 3:])[..., 0], w], dim=-1)


def inverse(g):
    rt = g[..., :3].transpose(-1, -2)
    return torch.cat([rt, -(rt @ g[..., 3:])], dim=-1)


def compose(a, b):
    ra = a[..., :3]
    return torch.cat([ra @ b[..., :3], ra @ b[..., 3:] + a[..., 3:]], dim=-1)


def perturb(g, d):
    """g (I + d^): the first-order curve through g along tangent d (..., 6).
    Its derivative at d = 0 is that of g exp(d), with no exp to guard."""
    r = g[..., :3]
    return torch.cat([r + r @ hat(d[..., 3:]), g[..., 3:] + r @ d[..., :3, None]], dim=-1)


def local(a, b):
    """log(a^-1 b)."""
    return log(compose(inverse(a), b))
