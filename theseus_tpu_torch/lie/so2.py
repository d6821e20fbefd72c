"""Functional SO(2) ops on (cos, sin) pairs (JAX counterpart: theseus_tpu/lie/so2.py).

Element (..., 2) = (cos theta, sin theta); tangent (..., 1). The group is
commutative and one-dimensional, so exp, log, compose and inverse have
trivial (+-1) jacobians. All ops broadcast over leading batch dims.
"""

from __future__ import annotations

import math

import torch

from .utils import draw

DOF = 1
SHAPE = (2,)
NAME = "SO2"


def _ones(batch, like: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    return torch.full(tuple(batch) + (1, 1), value, dtype=like.dtype, device=like.device)


def exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 1) -> (..., 2)."""
    theta = w[..., 0]
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def jexp(w: torch.Tensor):
    return [_ones(w.shape[:-1], w)], exp(w)


def log(g: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 1)."""
    return torch.atan2(g[..., 1], g[..., 0])[..., None]


def jlog(g: torch.Tensor):
    return [_ones(g.shape[:-1], g)], log(g)


def compose(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    c1, s1 = g1[..., 0], g1[..., 1]
    c2, s2 = g2[..., 0], g2[..., 1]
    return torch.stack([c1 * c2 - s1 * s2, s1 * c2 + c1 * s2], dim=-1)


def jcompose(g1: torch.Tensor, g2: torch.Tensor):
    one = _ones(torch.broadcast_shapes(g1.shape[:-1], g2.shape[:-1]), g1)
    return [one, one], compose(g1, g2)


def inverse(g: torch.Tensor) -> torch.Tensor:
    return torch.stack([g[..., 0], -g[..., 1]], dim=-1)


def jinverse(g: torch.Tensor):
    return [_ones(g.shape[:-1], g, -1.0)], inverse(g)


def adjoint(g: torch.Tensor) -> torch.Tensor:
    return _ones(g.shape[:-1], g)


def to_matrix(g: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 2, 2) rotation matrix."""
    c, s = g[..., 0], g[..., 1]
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def rotate(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    c, s = g[..., 0:1], g[..., 1:2]
    return torch.cat([c * p[..., 0:1] - s * p[..., 1:2], s * p[..., 0:1] + c * p[..., 1:2]], dim=-1)


def jrotate(g: torch.Tensor, p: torch.Tensor):
    """([d/d tangent (..., 2, 1), d/d point (..., 2, 2)], R p):
    d/d delta rotate(g exp(delta), p) = R perp(p)."""
    perp = torch.stack([-p[..., 1], p[..., 0]], dim=-1)
    return [rotate(g, perp)[..., None], to_matrix(g)], rotate(g, p)


def unrotate(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return rotate(inverse(g), p)


def junrotate(g: torch.Tensor, p: torch.Tensor):
    ret = unrotate(g, p)
    jg = torch.stack([ret[..., 1], -ret[..., 0]], dim=-1)[..., None]
    return [jg, to_matrix(inverse(g))], ret


act = rotate


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 1) -> (..., 2, 2) skew matrix."""
    theta = w[..., 0]
    zero = torch.zeros_like(theta)
    return torch.stack([torch.stack([zero, -theta], dim=-1), torch.stack([theta, zero], dim=-1)], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    return m[..., 1, 0][..., None]


lift = hat


def project(m: torch.Tensor) -> torch.Tensor:
    """Adjoint of lift: (..., 2, 2) -> (..., 1), <lift(x), m> = <x, project(m)>."""
    return (m[..., 1, 0] - m[..., 0, 1])[..., None]


def left_act(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """R(g) @ m for m of shape (..., 2, K)."""
    return to_matrix(g) @ m


def left_project(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A Euclidean gradient in matrix form (..., 2, 2) -> right tangent (..., 1): project(R^T m)."""
    return project(to_matrix(g).transpose(-1, -2) @ m)


def egrad_to_tangent(g: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """A Euclidean gradient (..., 2) wrt (cos, sin) -> right tangent (..., 1):
    g exp(delta) moves along (-sin, cos) at delta = 0."""
    return (-g[..., 1] * grad[..., 0] + g[..., 0] * grad[..., 1])[..., None]


def identity(*batch, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor([1.0, 0.0], dtype=dtype, device=device).expand(tuple(batch) + (2,))


def rand(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """Angles uniform in [-pi, pi)."""
    u = draw(False, tuple(batch) + (1,), generator, dtype, device)
    return exp(math.pi * (2.0 * u - 1.0))


def randn(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """exp of N(0, pi^2) angles."""
    return exp(math.pi * draw(True, tuple(batch) + (1,), generator, dtype, device))


def normalize(g: torch.Tensor) -> torch.Tensor:
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def check_group_tensor(g: torch.Tensor, atol: float = 1e-4) -> torch.Tensor:
    """(...,) bool: is each element a unit (cos, sin) pair."""
    return torch.abs(torch.sum(g * g, dim=-1) - 1.0) < atol
