"""Functional SE(3) ops on 3x4 [R | t] matrices (JAX counterpart: theseus_tpu/lie/se3.py).

Layout (..., 3, 4) with the rotation in [..., :3] and the translation in
[..., 3]; tangents are [linear(3); angular(3)] with right perturbation
g * exp(delta). The JAX module's functions, with its Taylor branches and
eps: exp, log, compose, inverse and their jacobians, the adjoint, the
point action (transform, untransform and their jacobians), hat/vee/lift/
project, left_act and `left_project` (the DLM backward's), to_matrix,
identity, rand, randn, normalize and check_group_tensor. `exp` and `log`
carry the JAX package's custom JVP rules as autograd Functions (see
lie/so3.py), taken whenever the call could be differentiated.
"""

from __future__ import annotations

import math

import torch

from ..config import get_eps, needs_grad
from . import so3
from .utils import antisym_project, draw, eye, mvp, nz, outer, so3_hat, transpose

DOF = 6
SHAPE = (3, 4)
NAME = "SE3"

_D_OMC_NEAR_ZERO = -1.0 / 12.0
_D_TMS_NEAR_ZERO = -1.0 / 60.0


def rotation(g: torch.Tensor) -> torch.Tensor:
    return g[..., :3]


def translation(g: torch.Tensor) -> torch.Tensor:
    return g[..., 3]


def from_rot_trans(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([r, t[..., None]], dim=-1)


def hat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4) se(3) matrix, [lin; ang] ordering."""
    top = torch.cat([so3_hat(x[..., 3:]), x[..., :3, None]], dim=-1)
    bottom = torch.zeros(x.shape[:-1] + (1, 4), dtype=x.dtype, device=x.device)
    return torch.cat([top, bottom], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6)."""
    ang = torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)
    return torch.cat([m[..., :3, 3], ang], dim=-1)


def lift(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 4): [hat(ang) | lin]."""
    return torch.cat([so3_hat(x[..., 3:]), x[..., :3, None]], dim=-1)


def project(m: torch.Tensor) -> torch.Tensor:
    """Adjoint of lift: (..., 3, 4) -> (..., 6) = [m[:, 3]; so3.project(m[:, :3])]."""
    return torch.cat([m[..., 3], so3.project(m[..., :3])], dim=-1)


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
    return from_rot_trans(r, t), (theta, nz(theta2, near_zero), sbt, omc, tms_t)


def jexp(x: torch.Tensor):
    """6x6 right Jacobian of exp and exp itself: ([J], G)."""
    ret, (theta, theta2_nz, sbt, omc, tms_t) = _exp_helper(x)
    near_zero = theta < get_eps("so3", "near_zero", x.dtype)
    tms_rot = torch.where(near_zero, torch.zeros_like(theta), tms_t)

    v, w = x[..., :3], x[..., 3:]
    jrot = tms_rot[..., None, None] * outer(w, w)
    jrot = jrot + sbt[..., None, None] * eye(3, x)
    jrot = jrot - omc[..., None, None] * so3_hat(w)

    d_omc = torch.where(near_zero, _D_OMC_NEAR_ZERO, (sbt - 2.0 * omc) / theta2_nz)
    d_tms = torch.where(near_zero, _D_TMS_NEAR_ZERO, (omc - 3.0 * tms_t) / theta2_nz)

    wv = torch.linalg.cross(w, v, dim=-1)
    wwv = torch.linalg.cross(w, wv, dim=-1)
    sw = tms_t[..., None] * w

    jac_temp_t = outer(d_omc[..., None] * wv + d_tms[..., None] * wwv, w)
    jac_temp_t = jac_temp_t - outer(v, sw)
    jac_temp_t = jac_temp_t + so3_hat(-omc[..., None] * v - tms_t[..., None] * wv)
    jac_temp_t = jac_temp_t + torch.sum(sw * v, dim=-1)[..., None, None] * eye(3, x)
    q = transpose(ret[..., :3]) @ jac_temp_t

    top = torch.cat([jrot, q], dim=-1)
    bottom = torch.cat([torch.zeros_like(q), jrot], dim=-1)
    return [torch.cat([top, bottom], dim=-2)], ret


class _Exp(torch.autograd.Function):
    """exp with the JAX rule dG = [R hat(d_ang) | R d_lin], d = J dx
    (`jvp`), and its transpose (`backward`); J is evaluated at the saved
    input with differentiable ops (see lie/so3.py)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return _exp_helper(x)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, gg):
        (x,) = ctx.saved_tensors
        (jac,), g = jexp(x)
        rt = transpose(g[..., :3])
        d_lin = mvp(rt, gg[..., 3])
        d_ang = 2.0 * antisym_project(rt @ gg[..., :3])
        return mvp(transpose(jac), torch.cat([d_lin, d_ang], dim=-1))

    @staticmethod
    def jvp(ctx, dx):
        (x,) = ctx.saved_tensors
        (jac,), g = jexp(x)
        d = mvp(jac, dx)
        r = g[..., :3]
        return torch.cat([r @ so3_hat(d[..., 3:]), mvp(r, d[..., :3])[..., None]], dim=-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3). (..., 6) -> (..., 3, 4)."""
    if needs_grad(x):
        return _Exp.apply(x)
    return _exp_helper(x)[0]


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


class _Log(torch.autograd.Function):
    """log with the JAX rule dx = J [R^T dt; antisym_project(R^T dR)]
    (`jvp`), and its transpose (`backward`); J is evaluated at the saved
    input with differentiable ops."""

    generate_vmap_rule = True

    @staticmethod
    def forward(g):
        return _log_helper(g)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, gx):
        (g,) = ctx.saved_tensors
        (jac,), _ = jlog(g)
        r = g[..., :3]
        v = mvp(transpose(jac), gx)
        d_rot = r @ (0.5 * so3_hat(v[..., 3:]))
        d_t = mvp(r, v[..., :3])
        return torch.cat([d_rot, d_t[..., None]], dim=-1)

    @staticmethod
    def jvp(ctx, dg):
        (g,) = ctx.saved_tensors
        (jac,), _ = jlog(g)
        rt = transpose(g[..., :3])
        d_ang = antisym_project(rt @ dg[..., :3])
        d_lin = mvp(rt, dg[..., 3])
        return mvp(jac, torch.cat([d_lin, d_ang], dim=-1))


def log(g: torch.Tensor) -> torch.Tensor:
    """Logarithm map SE(3) -> se(3). (..., 3, 4) -> (..., 6)."""
    if needs_grad(g):
        return _Log.apply(g)
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


def jcompose(g1: torch.Tensor, g2: torch.Tensor):
    """J1 = Adj(g2^{-1}), J2 = I."""
    b = torch.broadcast_shapes(g1.shape[:-2], g2.shape[:-2])
    j1 = adjoint(inverse(g2)).expand(b + (6, 6))
    return [j1, eye(6, g1).expand(b + (6, 6))], compose(g1, g2)


def inverse(g: torch.Tensor) -> torch.Tensor:
    r, t = g[..., :3], g[..., 3]
    rt = transpose(r)
    return from_rot_trans(rt, -mvp(rt, t))


def jinverse(g: torch.Tensor):
    return [-adjoint(g)], inverse(g)


def adjoint(g: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint: [[R, hat(t) R], [0, R]] with [lin; ang] ordering."""
    r, t = g[..., :3], g[..., 3]
    htr = so3_hat(t) @ r
    top = torch.cat([r, htr], dim=-1)
    bottom = torch.cat([torch.zeros_like(htr), r], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply the pose to a point: R p + t. (..., 3, 4), (..., 3) -> (..., 3)."""
    return mvp(g[..., :3], p) + g[..., 3]


def jtransform(g: torch.Tensor, p: torch.Tensor):
    """([d/d tangent (..., 3, 6), d/d point (..., 3, 3)], R p + t)."""
    r = g[..., :3]
    b = torch.broadcast_shapes(g.shape[:-2], p.shape[:-1])
    jg = torch.cat([r.expand(b + (3, 3)), r @ (-so3_hat(p))], dim=-1)
    return [jg.expand(b + (3, 6)), r.expand(b + (3, 3))], transform(g, p)


def untransform(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply the inverse pose to a point: R^T (p - t)."""
    return mvp(transpose(g[..., :3]), p - g[..., 3])


def juntransform(g: torch.Tensor, p: torch.Tensor):
    ret = untransform(g, p)
    b = torch.broadcast_shapes(g.shape[:-2], p.shape[:-1])
    jg = torch.cat([-eye(3, g).expand(b + (3, 3)), so3_hat(ret).expand(b + (3, 3))], dim=-1)
    return [jg, transpose(g[..., :3]).expand(b + (3, 3))], ret


act = transform


def left_act(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return g[..., :3] @ m


def to_matrix(g: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> homogeneous (..., 4, 4)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype, device=g.device).expand(g.shape[:-2] + (1, 4))
    return torch.cat([g, bottom], dim=-2)


def identity(*batch, dtype: torch.dtype, device) -> torch.Tensor:
    base = torch.zeros(3, 4, dtype=dtype, device=device)
    base[:, :3] = torch.eye(3, dtype=dtype, device=device)
    return base.expand(tuple(batch) + (3, 4))


def left_project(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A Euclidean gradient (..., 3, 4) -> right tangent (..., 6): [R^T m_t;
    so3.project(R^T m_R)]."""
    rt = transpose(g[..., :3])
    return torch.cat([mvp(rt, m[..., 3]), so3.project(rt @ m[..., :3])], dim=-1)


def rand(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """A uniform rotation and a translation uniform in [-1, 1)^3."""
    r = so3.rand(*batch, generator=generator, dtype=dtype, device=device)
    t = 2.0 * draw(False, tuple(batch) + (3,), generator, dtype, device) - 1.0
    return from_rot_trans(r, t)


def randn(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """exp of N(0, pi^2) tangents."""
    return exp(math.pi * draw(True, tuple(batch) + (6,), generator, dtype, device))


def normalize(g: torch.Tensor) -> torch.Tensor:
    return from_rot_trans(so3.normalize(g[..., :3]), g[..., 3])


def check_group_tensor(g: torch.Tensor, atol=None) -> torch.Tensor:
    return so3.check_group_tensor(g[..., :3], atol)
