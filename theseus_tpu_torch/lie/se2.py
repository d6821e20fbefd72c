"""Functional SE(2) ops on (x, y, cos, sin) vectors (JAX counterpart: theseus_tpu/lie/se2.py).

Element (..., 4) = (x, y, cos t, sin t); tangent (..., 3) ordered
[lin(2); ang(1)], right perturbation g * exp(delta). The V-matrix
coefficients (`_vcoeffs`, `_dvcoeffs`) switch to their Taylor branches
under the `se2_*` eps of config.py; every guarded denominator takes `nz`'s
dummy in the branch not taken, so that the gradients at theta = 0 are
finite (the branch's zero cotangent never meets a division by zero). The
jacobians are the JAX package's closed forms. All ops broadcast over
leading batch dims, as the compiled objective's stacked (K, B, 4) bucket
operands need.
"""

from __future__ import annotations

import math

import torch

from ..config import get_eps
from . import so2
from .utils import draw, nz

DOF = 3
SHAPE = (4,)
NAME = "SE2"


def rotation(g: torch.Tensor) -> torch.Tensor:
    """The (cos, sin) half of the element."""
    return g[..., 2:4]


def translation(g: torch.Tensor) -> torch.Tensor:
    return g[..., 0:2]


def _vcoeffs(theta: torch.Tensor, dtype: torch.dtype):
    """a = sin t / t, b = (1 - cos t) / t with Taylor branches."""
    near_zero = torch.abs(theta) < get_eps("se2", "near_zero", dtype)
    theta_nz = nz(theta, near_zero)
    sine, cosine = torch.sin(theta), torch.cos(theta)
    theta2 = theta * theta
    a = torch.where(near_zero, 1.0 - theta2 / 6.0, sine / theta_nz)
    b = torch.where(near_zero, 0.5 * theta - theta * theta2 / 24.0, (1.0 - cosine) / theta_nz)
    return a, b, sine, cosine


def exp(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4)."""
    v, theta = x[..., 0:2], x[..., 2]
    a, b, sine, cosine = _vcoeffs(theta, x.dtype)
    tx = a * v[..., 0] - b * v[..., 1]
    ty = b * v[..., 0] + a * v[..., 1]
    return torch.stack([tx, ty, cosine, sine], dim=-1)


def _dvcoeffs(theta: torch.Tensor, dtype: torch.dtype):
    """d/dtheta of the V-matrix coefficients, with Taylor branches."""
    near_zero = torch.abs(theta) < get_eps("se2", "d_near_zero", dtype)
    theta2 = theta * theta
    theta2_nz = nz(theta2, near_zero)
    sine, cosine = torch.sin(theta), torch.cos(theta)
    da = torch.where(near_zero, -theta / 3.0, (cosine * theta - sine) / theta2_nz)
    db = torch.where(near_zero, 0.5 - theta2 / 8.0, (sine * theta - (1.0 - cosine)) / theta2_nz)
    return da, db


def _block3(m00, m01, m02, m10, m11, m12) -> torch.Tensor:
    """[[m00, m01, m02], [m10, m11, m12], [0, 0, 1]] over the batch dims."""
    zero, one = torch.zeros_like(m00), torch.ones_like(m00)
    return torch.stack(
        [
            torch.stack([m00, m01, m02], dim=-1),
            torch.stack([m10, m11, m12], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def jexp(x: torch.Tensor):
    """3x3 right Jacobian J_r = [[R^T V, R^T dV/dt v], [0, 1]] and exp(x)."""
    v, theta = x[..., 0:2], x[..., 2]
    a, b, s, c = _vcoeffs(theta, x.dtype)
    da, db = _dvcoeffs(theta, x.dtype)
    # R^T V with R^T = [[c, s], [-s, c]], V = [[a, -b], [b, a]]
    m00 = c * a + s * b
    m01 = -c * b + s * a
    m10 = -s * a + c * b
    m11 = s * b + c * a
    dvx = da * v[..., 0] - db * v[..., 1]
    dvy = db * v[..., 0] + da * v[..., 1]
    q0 = c * dvx + s * dvy
    q1 = -s * dvx + c * dvy
    return [_block3(m00, m01, q0, m10, m11, q1)], exp(x)


def log(g: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3)."""
    t = g[..., 0:2]
    theta = torch.atan2(g[..., 3], g[..., 2])
    a, b, _, _ = _vcoeffs(theta, g.dtype)
    # a^2 + b^2 >= 4/pi^2 on the principal branch: no guard needed
    det = a * a + b * b
    vx = (a * t[..., 0] + b * t[..., 1]) / det
    vy = (-b * t[..., 0] + a * t[..., 1]) / det
    return torch.stack([vx, vy, theta], dim=-1)


def jlog(g: torch.Tensor):
    """jlog = jexp(log(g))^{-1}, by the block-triangular structure:
    [[A, q], [0, 1]]^{-1} = [[A^{-1}, -A^{-1} q], [0, 1]]."""
    x = log(g)
    (jr,), _ = jexp(x)
    a00, a01, a10, a11 = jr[..., 0, 0], jr[..., 0, 1], jr[..., 1, 0], jr[..., 1, 1]
    q0, q1 = jr[..., 0, 2], jr[..., 1, 2]
    det = a00 * a11 - a01 * a10
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det
    r0 = -(i00 * q0 + i01 * q1)
    r1 = -(i10 * q0 + i11 * q1)
    return [_block3(i00, i01, r0, i10, i11, r1)], x


def compose(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    r1 = g1[..., 2:4]
    t = so2.rotate(r1, g2[..., 0:2]) + g1[..., 0:2]
    r = so2.compose(r1, g2[..., 2:4])
    return torch.cat([t, r], dim=-1)


def inverse(g: torch.Tensor) -> torch.Tensor:
    rinv = so2.inverse(g[..., 2:4])
    t = -so2.rotate(rinv, g[..., 0:2])
    return torch.cat([t, rinv], dim=-1)


def adjoint(g: torch.Tensor) -> torch.Tensor:
    """[[R, perp(-t)], [0, 1]] with perp(-t) = (t1, -t0); [lin; ang] ordering."""
    c, s = g[..., 2], g[..., 3]
    return _block3(c, -s, g[..., 1], s, c, -g[..., 0])


def jcompose(g1: torch.Tensor, g2: torch.Tensor):
    """J1 = Adj(g2^{-1}), J2 = I."""
    b = torch.broadcast_shapes(g1.shape[:-1], g2.shape[:-1])
    j1 = adjoint(inverse(g2)).expand(b + (3, 3))
    j2 = torch.eye(3, dtype=g1.dtype, device=g1.device).expand(b + (3, 3))
    return [j1, j2], compose(g1, g2)


def jinverse(g: torch.Tensor):
    return [-adjoint(g)], inverse(g)


def transform(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R p + t."""
    return so2.rotate(g[..., 2:4], p) + g[..., 0:2]


def jtransform(g: torch.Tensor, p: torch.Tensor):
    """([d/d tangent (..., 2, 3), d/d point (..., 2, 2)], R p + t)."""
    r = g[..., 2:4]
    rm = so2.to_matrix(r)
    perp = torch.stack([-p[..., 1], p[..., 0]], dim=-1)
    jtheta = so2.rotate(r, perp)[..., None]
    b = torch.broadcast_shapes(g.shape[:-1], p.shape[:-1])
    rm = rm.expand(b + (2, 2))
    return [torch.cat([rm, jtheta.expand(b + (2, 1))], dim=-1), rm], transform(g, p)


def untransform(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R^T (p - t)."""
    return so2.unrotate(g[..., 2:4], p - g[..., 0:2])


def juntransform(g: torch.Tensor, p: torch.Tensor):
    ret = untransform(g, p)
    b = torch.broadcast_shapes(g.shape[:-1], p.shape[:-1])
    eye = torch.eye(2, dtype=g.dtype, device=g.device).expand(b + (2, 2))
    perp = torch.stack([ret[..., 1], -ret[..., 0]], dim=-1)[..., None]
    jg = torch.cat([-eye, perp.expand(b + (2, 1))], dim=-1)
    rtm = so2.to_matrix(so2.inverse(g[..., 2:4])).expand(b + (2, 2))
    return [jg, rtm], ret


act = transform


def to_matrix(g: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> homogeneous (..., 3, 3) [[R, t], [0, 1]]."""
    top = torch.cat([so2.to_matrix(g[..., 2:4]), g[..., 0:2, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device).expand(g.shape[:-1] + (1, 3))
    return torch.cat([top, bottom], dim=-2)


def hat(x: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 3) = [lin(2); ang] -> se(2) matrix (..., 3, 3)."""
    top = torch.cat([so2.hat(x[..., 2:3]), x[..., :2, None]], dim=-1)
    bottom = torch.zeros(x.shape[:-1] + (1, 3), dtype=x.dtype, device=x.device)
    return torch.cat([top, bottom], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) = [m[:2, 2]; m[1, 0]]."""
    return torch.cat([m[..., :2, 2], m[..., 1:2, 0]], dim=-1)


def lift(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 2, 3): [hat(ang) | lin]."""
    return torch.cat([so2.hat(x[..., 2:3]), x[..., :2, None]], dim=-1)


def project(m: torch.Tensor) -> torch.Tensor:
    """Adjoint of lift: (..., 2, 3) -> (..., 3) = [m[:, 2]; so2.project(m[:, :2])]."""
    return torch.cat([m[..., 2], so2.project(m[..., :2])], dim=-1)


def left_act(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The rotation part's left action R(g) @ m, m (..., 2, K)."""
    return so2.to_matrix(g[..., 2:4]) @ m


def left_project(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A Euclidean gradient in [R | t] form (..., 2, 3) -> right tangent (..., 3)."""
    rt = so2.to_matrix(g[..., 2:4]).transpose(-1, -2)
    return torch.cat([(rt @ m[..., 2:3])[..., 0], so2.project(rt @ m[..., :2])], dim=-1)


def egrad_to_tangent(g: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """A Euclidean gradient (..., 4) -> right tangent (..., 3)."""
    c, s = g[..., 2], g[..., 3]
    gv0 = c * grad[..., 0] + s * grad[..., 1]
    gv1 = -s * grad[..., 0] + c * grad[..., 1]
    gtheta = -s * grad[..., 2] + c * grad[..., 3]
    return torch.stack([gv0, gv1, gtheta], dim=-1)


def identity(*batch, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device).expand(tuple(batch) + (4,))


def rand(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """Translation uniform in [-1, 1)^2, rotation uniform."""
    t = 2.0 * draw(False, tuple(batch) + (2,), generator, dtype, device) - 1.0
    return torch.cat([t, so2.rand(*batch, generator=generator, dtype=dtype, device=device)], dim=-1)


def randn(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """exp of N(0, pi^2) tangents."""
    return exp(math.pi * draw(True, tuple(batch) + (3,), generator, dtype, device))


def normalize(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([g[..., 0:2], so2.normalize(g[..., 2:4])], dim=-1)


def check_group_tensor(g: torch.Tensor, atol: float = 1e-4) -> torch.Tensor:
    return so2.check_group_tensor(g[..., 2:4], atol)
