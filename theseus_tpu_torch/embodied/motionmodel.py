"""Motion-model costs: the GP (GPMP2) prior and its weight, hinge limits, the nonholonomic constraint and quasi-static planar pushing (JAX counterpart: theseus_tpu/embodied/motionmodel.py).

The analytic costs take whole stacked buckets, (K, B, *shape) operands and
(K, B, ...) or shared (B, ...) aux; `QuasiStaticPushingPlanar` is written
for one instance and takes autodiff jacobians, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.cost_function import CostFunction, _as_batched_scalar
from ..core.cost_weight import CostWeight
from ..core.variable import Variable, as_variable
from ..lie import se2 as se2_ops
from ..lie import so2 as so2_ops


def _eye(dof: int, batch, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(dof, dtype=like.dtype, device=like.device).expand(tuple(batch) + (dof, dof))


class DoubleIntegrator(CostFunction):
    """err = [local(pose1, pose2) - dt vel1 ; vel2 - vel1], analytic
    jacobians."""

    has_analytic_jacobians = True

    def __init__(self, pose1, vel1, pose2, vel2, dt, cost_weight=None, name=None):
        dof = pose1.group.dof
        if not (vel1.group.dof == pose2.group.dof == vel2.group.dof == dof):
            raise ValueError("All DoubleIntegrator variables need equal dof.")
        super().__init__([pose1, vel1, pose2, vel2], [_as_batched_scalar(dt)], cost_weight, name)
        self.group = pose1.group

    def dim(self):
        return 2 * self.group.dof

    def error_impl(self, optim, aux):
        p1, v1, p2, v2 = optim
        (dt,) = aux  # (K, B, 1) or shared (B, 1)
        return torch.cat([self.group.local(p1, p2) - dt * v1, v2 - v1], dim=-1)

    def jacobians_impl(self, optim, aux):
        p1, v1, p2, v2 = optim
        (dt,) = aux
        dof = self.group.dof
        (jl1, jl2), diff = self.group.jlocal(p1, p2)
        err = torch.cat([diff - dt * v1, v2 - v1], dim=-1)
        batch = err.shape[:-1]
        eye = _eye(dof, batch, err)
        zero = torch.zeros_like(eye)
        j_p1 = torch.cat([jl1.expand(eye.shape), zero], dim=-2)
        j_v1 = torch.cat([-dt[..., None] * eye, -eye], dim=-2)
        j_p2 = torch.cat([jl2.expand(eye.shape), zero], dim=-2)
        j_v2 = torch.cat([zero, eye], dim=-2)
        return [j_p1, j_v1, j_p2, j_v2], err


class GPCostWeight(CostWeight):
    """The GPMP2 GP-prior weight: the upper Cholesky factor U (U^T U = W) of
    the 2 dof x 2 dof inverse covariance W assembled from Qc_inv and dt.
    The factor is `cholesky_ex` (no host sync on the card): a W that is not
    positive definite gives NaN, as the JAX package's cholesky does."""

    def __init__(self, Qc_inv, dt, name: Optional[str] = None):
        super().__init__(name)
        q = as_variable(Qc_inv)
        if q.tensor.ndim == 2:
            q.tensor = q.tensor[None]
        self.Qc_inv = q
        self.dt = _as_batched_scalar(dt)

    @property
    def aux_vars(self):
        return (self.Qc_inv, self.dt)

    @staticmethod
    def weight_factor(qc_inv, dt):
        """qc_inv (..., dof, dof), dt (..., 1) -> U (..., 2 dof, 2 dof)."""
        dt = dt[..., None]
        q11 = 12.0 * dt ** (-3.0) * qc_inv
        q12 = -6.0 * dt ** (-2.0) * qc_inv
        q22 = 4.0 / dt * qc_inv
        w = torch.cat([torch.cat([q11, q12], dim=-1), torch.cat([q12, q22], dim=-1)], dim=-2)
        low, info = torch.linalg.cholesky_ex(w.mT)
        low = torch.where((info != 0)[..., None, None], torch.nan, low)
        return low.mT

    def apply_batched(self, err, jacs, waux):
        qc_inv, dt = waux  # (K, B, dof, dof) or shared (B, dof, dof); (K, B, 1) or (B, 1)
        u = self.weight_factor(qc_inv, dt)
        werr = (u @ err[..., None])[..., 0]
        wjacs = None if jacs is None else [u @ j for j in jacs]
        return werr, wjacs


class GPMotionModel(DoubleIntegrator):
    """DoubleIntegrator with a GPCostWeight."""

    def __init__(self, pose1, vel1, pose2, vel2, dt, cost_weight, name=None):
        if not isinstance(cost_weight, GPCostWeight):
            raise ValueError("GPMotionModel requires a GPCostWeight.")
        super().__init__(pose1, vel1, pose2, vel2, dt, cost_weight, name)


class HingeCost(CostFunction):
    """Two-sided hinge on vector limits: zero inside
    [down + threshold, up - threshold], linear outside."""

    has_analytic_jacobians = True

    def __init__(self, vector, down_limit, up_limit, threshold, cost_weight=None, name=None):
        dof = vector.group.dof

        def conv(v):
            if isinstance(v, Variable):
                return v
            arr = np.asarray(v, dtype=np.float64) if not isinstance(v, torch.Tensor) else v
            if arr.ndim == 0:
                arr = arr * (np.ones((1, dof)) if not isinstance(arr, torch.Tensor) else torch.ones((1, dof)))
            elif arr.ndim == 1:
                arr = arr[None]
            return as_variable(arr)

        super().__init__([vector], [conv(down_limit), conv(up_limit), conv(threshold)], cost_weight, name)
        self._dof = dof

    def dim(self):
        return self._dof

    def _err(self, v, aux):
        down, up, thr = aux
        dl, ul = down + thr, up - thr
        below, above = v < dl, v > ul
        err = torch.where(below, dl - v, torch.where(above, v - ul, torch.zeros_like(v)))
        return err, below, above

    def error_impl(self, optim, aux):
        return self._err(optim[0], aux)[0]

    def jacobians_impl(self, optim, aux):
        err, below, above = self._err(optim[0], aux)
        one = torch.ones_like(err)
        diag = torch.where(below, -one, torch.where(above, one, torch.zeros_like(err)))
        return [torch.diag_embed(diag)], err


class Nonholonomic(CostFunction):
    """Zero side velocity for planar robots. The pose is SE2 or a
    3-vector (x, y, theta); the velocity a 3-vector."""

    has_analytic_jacobians = True

    def __init__(self, pose, vel, cost_weight=None, name=None):
        if vel.group.dof != 3 or pose.group.dof != 3:
            raise ValueError("Nonholonomic needs 3D pose and velocity.")
        super().__init__([pose, vel], [], cost_weight, name)
        self.pose_is_se2 = pose.group.name == "SE2"

    def dim(self):
        return 1

    def error_impl(self, optim, aux):
        pose, vel = optim
        if self.pose_is_se2:
            return vel[..., 1:2]
        cos, sin = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
        return (vel[..., 1] * cos - vel[..., 0] * sin)[..., None]

    def jacobians_impl(self, optim, aux):
        pose, vel = optim
        zero = torch.zeros_like(vel[..., 0])
        if self.pose_is_se2:
            jp = torch.zeros(vel.shape[:-1] + (1, 3), dtype=vel.dtype, device=vel.device)
            jv = torch.stack([zero, torch.ones_like(zero), zero], dim=-1)[..., None, :]
            return [jp, jv], vel[..., 1:2]
        cos, sin = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
        err = (vel[..., 1] * cos - vel[..., 0] * sin)[..., None]
        jp = torch.stack([zero, zero, -(vel[..., 1] * sin + vel[..., 0] * cos)], dim=-1)[..., None, :]
        jv = torch.stack([-sin, cos, zero], dim=-1)[..., None, :]
        return [jp, jv], err


class QuasiStaticPushingPlanar(CostFunction):
    """Planar pushing dynamics residual D V - Vp = 0 (Zhou et al. 2017)
    over SE2 object and effector poses at two time steps; autodiff
    jacobians."""

    has_analytic_jacobians = False

    def __init__(self, obj1, obj2, eff1, eff2, c_square, cost_weight=None, name=None):
        super().__init__([obj1, obj2, eff1, eff2], [_as_batched_scalar(c_square)], cost_weight, name)

    def dim(self):
        return 3

    def error_impl(self, optim, aux):
        obj1, obj2, eff1, eff2 = optim
        (c_square,) = aux
        o2_rot = obj2[2:4]

        # D from the current contact point in the object frame
        cp2 = eff2[:2]
        cp2_obj = se2_ops.untransform(obj2, cp2)
        px, py = cp2_obj[0], cp2_obj[1]
        one, zero = torch.ones_like(px), torch.zeros_like(px)
        d = torch.stack([
            torch.stack([one, zero, -py]),
            torch.stack([zero, one, px]),
            torch.stack([-py, px, -c_square[0]]),
        ])

        # V: the object's velocity in its frame and its angular velocity
        v_obj = so2_ops.unrotate(o2_rot, obj2[:2] - obj1[:2])
        omega = se2_ops.log(se2_ops.compose(se2_ops.inverse(obj1), obj2))[2]
        v = torch.stack([v_obj[0], v_obj[1], omega])

        # Vp: the contact point's velocity in the object frame
        vc_obj = so2_ops.unrotate(o2_rot, cp2 - eff1[:2])
        vp = torch.stack([vc_obj[0], vc_obj[1], zero])
        return d @ v - vp
