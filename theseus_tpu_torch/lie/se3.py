"""Functional SE(3) ops on 3x4 [R | t] matrices (JAX counterpart: theseus_tpu/lie/se3.py).

Layout (..., 3, 4) with the rotation in [..., :3] and the translation in
[..., 3]; tangents are [linear(3); angular(3)] with right perturbation
g * exp(delta). The subset the PGO path needs: exp, log, jlog, compose,
inverse, adjoint, with the JAX package's Taylor branches and eps.
"""

from __future__ import annotations

import torch

from ..config import get_eps
from . import so3
from .utils import eye, mvp, nz, outer, so3_hat, transpose

DOF = 6
SHAPE = (3, 4)
NAME = "SE3"


def from_rot_trans(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([r, t[..., None]], dim=-1)


def _exp_helper(x: torch.Tensor):
    v, w = x[..., :3], x[..., 3:]
    r, (theta, theta2, sine, _, sbt, omc) = so3._exp_helper(w)
    near_zero = theta < get_eps("so3", "near_zero", x.dtype)
    theta3_nz = nz(theta * theta2, near_zero)
    # translation branch keeps the Taylor value 1/6 - theta^2/120 near zero
    tms_t = torch.where(near_zero, 1.0 / 6.0 - theta2 / 120.0, (theta - sine) / theta3_nz)
    t = (
        sbt[..., None] * v
        + omc[..., None] * torch.linalg.cross(w, v, dim=-1)
        + tms_t[..., None] * w * torch.sum(w * v, dim=-1, keepdim=True)
    )
    return from_rot_trans(r, t)


def exp(x: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3). (..., 6) -> (..., 3, 4)."""
    return _exp_helper(x)


def _log_helper(g: torch.Tensor):
    r, t = g[..., :3], g[..., 3]
    ret_ang, (theta, sine, cosine) = so3._log_helper(r)

    near_zero = theta < get_eps("so3", "near_zero", g.dtype)
    theta2 = theta * theta
    sine_theta = sine * theta
    tcm2 = 2.0 * cosine - 2.0
    tcm2_nz = nz(tcm2, near_zero)
    theta2_nz = nz(theta2, near_zero)

    a = torch.where(near_zero, 1.0 - theta2 / 12.0, -sine_theta / tcm2_nz)
    b = torch.where(
        near_zero,
        1.0 / 12.0 + theta2 / 720.0,
        (sine_theta + tcm2) / (theta2_nz * tcm2_nz),
    )
    ret_lin = (
        a[..., None] * t
        - 0.5 * torch.linalg.cross(ret_ang, t, dim=-1)
        + b[..., None] * ret_ang * torch.sum(ret_ang * t, dim=-1, keepdim=True)
    )
    ret = torch.cat([ret_lin, ret_ang], dim=-1)
    return ret, (theta, theta2, theta2_nz, sine, cosine, tcm2_nz)


def log(g: torch.Tensor) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3). (..., 3, 4) -> (..., 6)."""
    return _log_helper(g)[0]


def jlog(g: torch.Tensor):
    """6x6 inverse right Jacobian at log(g): ([J], x)."""
    x, (theta, theta2, theta2_nz, sine, cosine, tcm2_nz) = _log_helper(g)
    ret_lin, ret_ang = x[..., :3], x[..., 3:]
    d_near_zero = theta < get_eps("so3", "d_near_zero", g.dtype)

    jrot = so3._jlog_from_w(ret_ang, theta, sine, cosine)
    b_dz = torch.where(
        d_near_zero,
        1.0 / 12.0 + theta2 / 720.0,
        (sine * theta + 2.0 * cosine - 2.0)
        / (nz(theta2, d_near_zero) * nz(2.0 * cosine - 2.0, d_near_zero)),
    )
    b_ret_ang = b_dz[..., None] * ret_ang

    theta_nz = nz(theta, d_near_zero)
    theta4_nz = theta2_nz * theta2_nz
    c = torch.where(
        d_near_zero,
        -1.0 / 360.0 - theta2 / 7560.0,
        -(2.0 * tcm2_nz + theta * sine + theta2) / (theta4_nz * tcm2_nz),
    )
    d = torch.where(
        d_near_zero,
        -1.0 / 6.0 - theta2 / 180.0,
        (theta - sine) / (theta_nz * tcm2_nz),
    )
    e = torch.sum(ret_ang * ret_lin, dim=-1)

    ce_ret_ang = (c * e)[..., None] * ret_ang
    jq = outer(ce_ret_ang, ret_ang)
    jq = jq + outer(b_ret_ang, ret_lin) + outer(ret_lin, b_ret_ang)
    jq = jq + (e * d)[..., None, None] * eye(3, g)
    jq = jq + 0.5 * so3_hat(ret_lin)

    top = torch.cat([jrot, jq], dim=-1)
    bottom = torch.cat([torch.zeros_like(jq), jrot], dim=-1)
    return [torch.cat([top, bottom], dim=-2)], x


def compose(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    r1, t1 = g1[..., :3], g1[..., 3]
    r2, t2 = g2[..., :3], g2[..., 3]
    return from_rot_trans(r1 @ r2, mvp(r1, t2) + t1)


def inverse(g: torch.Tensor) -> torch.Tensor:
    r, t = g[..., :3], g[..., 3]
    rt = transpose(r)
    return from_rot_trans(rt, -mvp(rt, t))


def adjoint(g: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint: [[R, hat(t) R], [0, R]] with [lin; ang] ordering."""
    r, t = g[..., :3], g[..., 3]
    htr = so3_hat(t) @ r
    top = torch.cat([r, htr], dim=-1)
    bottom = torch.cat([torch.zeros_like(htr), r], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def identity(*batch, dtype: torch.dtype, device) -> torch.Tensor:
    base = torch.zeros(3, 4, dtype=dtype, device=device)
    base[:, :3] = torch.eye(3, dtype=dtype, device=device)
    return base.expand(tuple(batch) + (3, 4))
