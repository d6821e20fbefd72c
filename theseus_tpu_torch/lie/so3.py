"""Functional SO(3) ops on 3x3 rotation matrices (JAX counterpart: theseus_tpu/lie/so3.py).

The subset the PGO path needs: exp, log, jlog, compose, inverse, adjoint.
Right-perturbation tangent convention, and the same Taylor branches and
per-dtype eps as the JAX package (exp near-zero Pade; log near-zero and
near-pi branches; jlog coefficients on the wider derivative eps). All ops
broadcast over leading batch dims. Forward only: no autograd rules yet.
"""

from __future__ import annotations

import torch

from ..config import get_eps
from .utils import antisym_project, eye, nz, outer, so3_hat, transpose

DOF = 3
SHAPE = (3, 3)
NAME = "SO3"

hat = so3_hat


def _exp_helper(w: torch.Tensor):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    near_zero = theta < get_eps("so3", "near_zero", w.dtype)
    theta_nz = nz(theta, near_zero)
    theta2_nz = nz(theta2, near_zero)

    # Pade near zero: cos t ~ 8/(4+t^2) - 1
    cosine = torch.where(near_zero, 8.0 / (4.0 + theta2) - 1.0, torch.cos(theta))
    sine = torch.sin(theta)
    sine_by_theta = torch.where(near_zero, 0.5 * cosine + 0.5, sine / theta_nz)
    one_minus_cosine_by_theta2 = torch.where(
        near_zero, 0.5 * sine_by_theta, (1.0 - cosine) / theta2_nz
    )

    ret = one_minus_cosine_by_theta2[..., None, None] * outer(w, w)
    ret = ret + cosine[..., None, None] * eye(3, w)
    ret = ret + sine_by_theta[..., None, None] * hat(w)
    return ret, (theta, theta2, sine, cosine, sine_by_theta, one_minus_cosine_by_theta2)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3). (..., 3) -> (..., 3, 3)."""
    return _exp_helper(w)[0]


def _log_helper(g: torch.Tensor):
    sine_axis = antisym_project(g)
    cosine = 0.5 * (g[..., 0, 0] + g[..., 1, 1] + g[..., 2, 2] - 1.0)
    sine = torch.linalg.vector_norm(sine_axis, dim=-1)
    theta = torch.atan2(sine, cosine)

    near_zero = theta < get_eps("so3", "near_zero", g.dtype)
    near_pi = (1.0 + cosine) <= get_eps("so3", "near_pi", g.dtype)
    near_either = near_zero | near_pi
    sine_nz = nz(sine, near_either)
    scale = torch.where(near_either, 1.0 + sine * sine / 6.0, theta / sine_nz)
    ret = sine_axis * scale[..., None]

    # near-pi branch: the axis from the major diagonal entry's row/column
    d0, d1, d2 = g[..., 0, 0], g[..., 1, 1], g[..., 2, 2]
    is1 = (d1 > d0) & (d1 > d2)
    is2 = (d2 > d0) & (d2 > d1)
    is0 = ~(is1 | is2)
    one_hot = torch.stack([is0, is1, is2], dim=-1).to(g.dtype)
    row = torch.sum(one_hot[..., :, None] * g, dim=-2)
    col = torch.sum(one_hot[..., None, :] * g, dim=-1)
    sel_rows = 0.5 * (row + col) - cosine[..., None] * one_hot
    axis_norm = torch.linalg.vector_norm(sel_rows, dim=-1)
    axis = sel_rows / nz(axis_norm, ~near_pi)[..., None]
    sine_major = torch.sum(sine_axis * one_hot, dim=-1)
    sign = torch.where(sine_major >= 0, 1.0, -1.0).to(g.dtype)
    w = torch.where(near_pi[..., None], axis * (theta * sign)[..., None], ret)
    return w, (theta, sine, cosine)


def _jlog_from_w(w, theta, sine, cosine):
    """jlog = J_r^{-1} = a I + 0.5 hat(w) + b w w^T."""
    d_near_zero = theta < get_eps("so3", "d_near_zero", w.dtype)
    theta2 = theta * theta
    sine_theta = sine * theta
    two_cos_minus_two = 2.0 * cosine - 2.0
    tcm2_nz = nz(two_cos_minus_two, d_near_zero)
    theta2_nz = nz(theta2, d_near_zero)

    a = torch.where(d_near_zero, 1.0 - theta2 / 12.0, -sine_theta / tcm2_nz)
    b = torch.where(
        d_near_zero,
        1.0 / 12.0 + theta2 / 720.0,
        (sine_theta + two_cos_minus_two) / (theta2_nz * tcm2_nz),
    )
    jac = b[..., None, None] * outer(w, w)
    jac = jac + 0.5 * hat(w)
    jac = jac + a[..., None, None] * eye(3, w)
    return jac


def log(g: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3). (..., 3, 3) -> (..., 3)."""
    return _log_helper(g)[0]


def jlog(g: torch.Tensor):
    """Returns ([jlog], w) with jlog the right-inverse Jacobian of log."""
    w, (theta, sine, cosine) = _log_helper(g)
    return [_jlog_from_w(w, theta, sine, cosine)], w


def compose(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    return g1 @ g2


def inverse(g: torch.Tensor) -> torch.Tensor:
    return transpose(g)


def adjoint(g: torch.Tensor) -> torch.Tensor:
    return g

