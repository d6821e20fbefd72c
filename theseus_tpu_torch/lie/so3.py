"""Functional SO(3) ops on 3x3 rotation matrices (JAX counterpart: theseus_tpu/lie/so3.py).

The JAX module's functions: exp, log and their jacobians, compose,
inverse and theirs, the adjoint, the point action (rotate, unrotate and
their jacobians), hat/vee/lift/project, left_act and `left_project` (a
Euclidean gradient to the right tangent, the DLM backward's), the
quaternion conversions (the g2o reader), identity, rand, randn, normalize
and check_group_tensor. Right-perturbation tangent convention, and the same Taylor branches and
per-dtype eps as the JAX package (exp near-zero Pade; log near-zero and
near-pi branches; jlog coefficients on the wider derivative eps). All ops
broadcast over leading batch dims. `exp` and `log` carry the JAX
package's custom JVP rules as autograd Functions (the plain formulas give
NaN gradients at an exact zero tangent: sqrt and the norm at 0, each 0 * inf
under torch.where), with a `jvp` for torch.func.jacfwd, a `backward` and a
generated vmap rule; they are taken whenever the call could be
differentiated (`config.needs_grad`: autograd recording, or a torch.func
transform).
"""

from __future__ import annotations

import math

import torch

from ..config import get_eps, needs_grad
from .utils import antisym_project, draw, eye, mvp, nz, outer, so3_hat, so3_vee, transpose

DOF = 3
SHAPE = (3, 3)
NAME = "SO3"

hat = so3_hat
vee = so3_vee
lift = so3_hat


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


def jexp(w: torch.Tensor):
    """Right Jacobian of exp and the exp itself: ([J], R), with
    J_r = sin(t)/t I - (1-cos t)/t^2 hat(w) + (t - sin t)/t^3 w w^T."""
    ret, (theta, theta2, sine, _, sbt, omc) = _exp_helper(w)
    near_zero = theta < get_eps("so3", "near_zero", w.dtype)
    theta3_nz = nz(theta * theta2, near_zero)
    t_m_sine_by_t3 = torch.where(near_zero, torch.zeros_like(theta), (theta - sine) / theta3_nz)
    jac = t_m_sine_by_t3[..., None, None] * outer(w, w)
    jac = jac + sbt[..., None, None] * eye(3, w)
    jac = jac - omc[..., None, None] * hat(w)
    return [jac], ret


class _Exp(torch.autograd.Function):
    """exp with the JAX rule dR = R hat(J_r dw): `jvp` is the rule (what
    torch.func.jacfwd takes), `backward` its transpose. Both evaluate J_r at
    the saved input with differentiable ops, so that a derivative of the
    rule (a jacobian differentiated again, as the unrolled and implicit
    backward do with autodiff costs) is the JAX package's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(w):
        return _exp_helper(w)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        (jac,), r = jexp(w)
        # <G, R hat(v)> = 2 antisym_project(R^T G) . v
        return mvp(transpose(jac), 2.0 * antisym_project(transpose(r) @ g))

    @staticmethod
    def jvp(ctx, dw):
        (w,) = ctx.saved_tensors
        (jac,), r = jexp(w)
        return r @ hat(mvp(jac, dw))


def exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3). (..., 3) -> (..., 3, 3)."""
    if needs_grad(w):
        return _Exp.apply(w)
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


class _Log(torch.autograd.Function):
    """log with the JAX rule dw = jlog antisym_project(R^T dR) (`jvp`) and
    its transpose (`backward`), jlog evaluated at the saved input as in
    _Exp."""

    generate_vmap_rule = True

    @staticmethod
    def forward(g):
        return _log_helper(g)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def backward(ctx, gw):
        (g,) = ctx.saved_tensors
        (jac,), _ = jlog(g)
        # the adjoint of antisym_project is 0.5 hat
        return g @ (0.5 * hat(mvp(transpose(jac), gw)))

    @staticmethod
    def jvp(ctx, dg):
        (g,) = ctx.saved_tensors
        (jac,), _ = jlog(g)
        return mvp(jac, antisym_project(transpose(g) @ dg))


def log(g: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3). (..., 3, 3) -> (..., 3)."""
    if needs_grad(g):
        return _Log.apply(g)
    return _log_helper(g)[0]


def jlog(g: torch.Tensor):
    """Returns ([jlog], w) with jlog the right-inverse Jacobian of log."""
    w, (theta, sine, cosine) = _log_helper(g)
    return [_jlog_from_w(w, theta, sine, cosine)], w


def compose(g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    return g1 @ g2


def jcompose(g1: torch.Tensor, g2: torch.Tensor):
    """J1 = Adj(g2^{-1}) = g2^T, J2 = I."""
    b = torch.broadcast_shapes(g1.shape[:-2], g2.shape[:-2])
    return [transpose(g2).expand(b + (3, 3)), eye(3, g1).expand(b + (3, 3))], g1 @ g2


def inverse(g: torch.Tensor) -> torch.Tensor:
    return transpose(g)


def jinverse(g: torch.Tensor):
    """J = -Adj(g) = -g."""
    return [-g], transpose(g)


def adjoint(g: torch.Tensor) -> torch.Tensor:
    return g


def rotate(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate point(s): (..., 3, 3), (..., 3) -> (..., 3)."""
    return mvp(g, p)


act = rotate


def _bshape(g: torch.Tensor, p: torch.Tensor):
    return torch.broadcast_shapes(g.shape, p.shape[:-1] + (3, 3))


def jrotate(g: torch.Tensor, p: torch.Tensor):
    """([d/d tangent, d/d point], R p)."""
    return [g @ (-hat(p)), g.expand(_bshape(g, p))], mvp(g, p)


def unrotate(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return mvp(transpose(g), p)


def junrotate(g: torch.Tensor, p: torch.Tensor):
    ret = mvp(transpose(g), p)
    return [hat(ret), transpose(g).expand(_bshape(g, p))], ret


def left_act(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, K)."""
    return g @ m


def to_matrix(g: torch.Tensor) -> torch.Tensor:
    """The storage is the rotation matrix itself."""
    return g


def project(m: torch.Tensor) -> torch.Tensor:
    """Adjoint of hat: the full antisymmetric differences, (..., 3, 3) -> (..., 3)."""
    return 2.0 * antisym_project(m)


def left_project(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """project(g^{-1} m): a Euclidean gradient (..., 3, 3) -> right tangent (..., 3)."""
    return project(transpose(g) @ m)


def identity(*batch, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device).expand(tuple(batch) + (3, 3))


def rand(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform random rotations, from normalized Gaussian quaternions."""
    return quaternion_to_rotation(draw(True, tuple(batch) + (4,), generator, dtype, device))


def randn(*batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """exp of N(0, pi^2) tangents."""
    return exp(math.pi * draw(True, tuple(batch) + (3,), generator, dtype, device))


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion, normalized here -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_to_quaternion(g: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz with w >= 0 (Shepperd: of four
    constructions, the one with the largest pivot)."""
    m00, m01, m02 = g[..., 0, 0], g[..., 0, 1], g[..., 0, 2]
    m10, m11, m12 = g[..., 1, 0], g[..., 1, 1], g[..., 1, 2]
    m20, m21, m22 = g[..., 2, 0], g[..., 2, 1], g[..., 2, 2]
    tr = m00 + m11 + m22

    def q_from(tw, tx, ty, tz, pivot):
        s = torch.sqrt(torch.clamp(pivot, min=1e-12))
        return torch.stack([tw / s, tx / s, ty / s, tz / s], dim=-1)

    q0 = q_from(0.5 * (1 + tr), 0.5 * (m21 - m12), 0.5 * (m02 - m20), 0.5 * (m10 - m01), 1 + tr)
    q1 = q_from(0.5 * (m21 - m12), 0.5 * (1 + m00 - m11 - m22), 0.5 * (m01 + m10), 0.5 * (m02 + m20),
                1 + m00 - m11 - m22)
    q2 = q_from(0.5 * (m02 - m20), 0.5 * (m01 + m10), 0.5 * (1 - m00 + m11 - m22), 0.5 * (m12 + m21),
                1 - m00 + m11 - m22)
    q3 = q_from(0.5 * (m10 - m01), 0.5 * (m02 + m20), 0.5 * (m12 + m21), 0.5 * (1 - m00 - m11 + m22),
                1 - m00 - m11 + m22)
    diag = torch.stack([m00, m11, m22], dim=-1)
    case = torch.where(tr > 0, torch.zeros_like(tr, dtype=torch.long), torch.argmax(diag, dim=-1) + 1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, case[..., None, None].expand(case.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def normalize(g: torch.Tensor) -> torch.Tensor:
    """The nearest rotation of a (..., 3, 3) matrix, by SVD."""
    u, _, vt = torch.linalg.svd(g)
    d = torch.linalg.det(u @ vt)
    s = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (u * s[..., None, :]) @ vt


def check_group_tensor(g: torch.Tensor, atol=None) -> torch.Tensor:
    """(...,) bool: is each element orthonormal with determinant 1."""
    if atol is None:
        atol = get_eps("so3", "matrix", g.dtype)
    err = torch.abs(transpose(g) @ g - eye(3, g)).amax(dim=(-2, -1))
    return (err < atol) & (torch.abs(torch.linalg.det(g) - 1.0) < atol)
