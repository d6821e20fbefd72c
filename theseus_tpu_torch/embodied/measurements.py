"""Measurement cost functions: Between, MovingFrameBetween and Reprojection (JAX counterpart: theseus_tpu/embodied/measurements.py).

Between: residual = log(measurement^{-1} (v1^{-1} v2)), the PGO workhorse,
with analytic jacobians J2 = jlog(m^{-1} d), J1 = -J2 Adj(d^{-1}),
d = v1^{-1} v2. For SE3 the whole bucket goes through the fused
linearization (ops/between_se3.py).

MovingFrameBetween: a Between of two poses each seen from its own moving
frame (tactile estimation), jacobians chained through jlog.

Reprojection: the bundle-adjustment residual (pinhole camera with 2-term
radial distortion, BAL convention). Its whole bucket goes through the fused
linearization of ops/reprojection.py.

Fused paths launch the CUDA kernel on the card and run its plain twin on
the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.cost_function import CostFunction
from ..core.cost_weight import CostWeight
from ..core.variable import ManifoldVariable, as_variable
from ..lie.utils import mvp


class Between(CostFunction):
    has_analytic_jacobians = True

    def __init__(
        self,
        v1: ManifoldVariable,
        v2: ManifoldVariable,
        measurement,
        cost_weight: Optional[CostWeight] = None,
        name: Optional[str] = None,
    ):
        if v1.group != v2.group:
            raise ValueError("Between requires variables of the same group.")
        measurement = as_variable(measurement)
        super().__init__([v1, v2], [measurement], cost_weight, name)
        self.group = v1.group

    def dim(self):
        return self.group.dof

    def error_impl(self, optim, aux):
        v1, v2 = optim
        (meas,) = aux
        g = self.group
        return g.local(meas, g.between(v1, v2))

    def jacobians_impl(self, optim, aux):
        v1, v2 = optim
        (meas,) = aux
        g = self.group
        diff = g.between(v1, v2)
        (jl,), res = g.jlog(g.compose(g.inverse(meas), diff))
        j1 = -(jl @ g.adjoint(g.inverse(diff)))
        return [j1, jl], res

    def fused_linearize(self, xs, aux):
        """Whole-bucket fused SE3 linearization. xs: per-slot stacked
        (K, B, 3, 4); aux: ((K, B, 3, 4) or shared (B, 3, 4),).
        Returns ((j1, j2), err) of shapes (K, B, 6, 6) / (K, B, 6). The
        kernel is SE3's: another group takes the analytic jacobians."""
        from ..ops.between_se3 import between_linearize

        if self.group.name != "SE3":
            jacs, err = self.jacobians_impl(xs, aux)
            return tuple(jacs), err
        v1, v2 = xs
        (meas,) = aux
        j1, j2, err = between_linearize(v1, v2, meas)
        return (j1, j2), err

    def fused_error(self, xs, aux):
        """Error-only evaluation through the same fused kernel."""
        if self.group.name != "SE3":
            return self.error_impl(xs, aux)
        return self.fused_linearize(xs, aux)[1]


class MovingFrameBetween(CostFunction):
    """residual = log(m^{-1} B) with B = (f1^{-1} p1)^{-1} (f2^{-1} p2); the
    jacobians chain through jlog (the JAX package's choice)."""

    has_analytic_jacobians = True

    def __init__(self, frame1, frame2, pose1, pose2, measurement, cost_weight=None, name=None):
        if len({v.group.name for v in (frame1, frame2, pose1, pose2)}) > 1:
            raise ValueError("Inconsistent variable types.")
        super().__init__([frame1, frame2, pose1, pose2], [as_variable(measurement)], cost_weight, name)
        self.group = frame1.group

    def dim(self):
        return self.group.dof

    def error_impl(self, optim, aux):
        f1, f2, p1, p2 = optim
        (meas,) = aux
        g = self.group
        return g.local(meas, g.between(g.between(f1, p1), g.between(f2, p2)))

    def jacobians_impl(self, optim, aux):
        f1, f2, p1, p2 = optim
        (meas,) = aux
        g = self.group
        (jb1_f1, jb1_p1), b1 = g.jbetween(f1, p1)
        (jb2_f2, jb2_p2), b2 = g.jbetween(f2, p2)
        (jo_b1, jo_b2), diff = g.jbetween(b1, b2)
        (jl,), res = g.jlog(g.compose(g.inverse(meas), diff))
        j1, j2 = jl @ jo_b1, jl @ jo_b2
        return [j1 @ jb1_f1, j2 @ jb2_f2, j1 @ jb1_p1, j2 @ jb2_p2], res


class Reprojection(CostFunction):
    """Pinhole + 2-parameter radial distortion reprojection residual
    (BAL camera convention: proj = -P_xy / P_z, factor = f (1 + r2 (k1 + r2 k2))),
    over an SE3 camera pose (world to camera) and a Point3 landmark.

    The JAX cost has no analytic jacobians and differentiates `error_impl`
    with jacfwd through the retract. Here `jacobians_impl` is the closed form
    (the plain twin of the fused kernel), which equals that jacfwd to float64
    rounding (tests/test_torch_reprojection.py)."""

    has_analytic_jacobians = True

    def __init__(
        self,
        camera_pose: ManifoldVariable,
        world_point: ManifoldVariable,
        focal_length,
        image_feature_point,
        calib_k1=None,
        calib_k2=None,
        cost_weight: Optional[CostWeight] = None,
        name: Optional[str] = None,
    ):
        focal_length = as_variable(focal_length)
        image_feature_point = as_variable(image_feature_point)
        calib_k1 = as_variable(calib_k1 if calib_k1 is not None else np.zeros((1, 1)))
        calib_k2 = as_variable(calib_k2 if calib_k2 is not None else np.zeros((1, 1)))
        super().__init__(
            [camera_pose, world_point],
            [focal_length, image_feature_point, calib_k1, calib_k2],
            cost_weight,
            name,
        )
        self.group = camera_pose.group

    def dim(self):
        return 2

    def error_impl(self, optim, aux):
        pose, point = optim
        focal, feat, k1, k2 = aux  # (K, B, s) or shared (B, s): right-aligned broadcast
        p_cam = mvp(pose[..., :3], point) + pose[..., 3]
        proj = -p_cam[..., :2] / p_cam[..., 2:3]
        r2 = torch.sum(proj * proj, dim=-1, keepdim=True)
        factor = focal * (1.0 + r2 * (k1 + r2 * k2))
        return proj * factor - feat

    def jacobians_impl(self, optim, aux):
        from ..ops.reprojection import broadcast_aux, reprojection_linearize_plain

        pose, point = optim
        jpose, jpt, err = reprojection_linearize_plain(pose, point, *broadcast_aux(pose, aux))
        return [jpose, jpt], err

    def fused_linearize(self, xs, aux):
        """Whole-bucket fused linearization. xs: (pose (K, B, 3, 4),
        point (K, B, 3)); aux: focal, feat, k1, k2, each (K, B, s) or shared
        (B, s). Returns ((jpose (K, B, 2, 6), jpt (K, B, 2, 3)), err (K, B, 2))."""
        from ..ops.reprojection import reprojection_linearize

        jpose, jpt, err = reprojection_linearize(*xs, *aux)
        return (jpose, jpt), err

    def fused_error(self, xs, aux):
        """Error-only evaluation through the same fused kernel."""
        return self.fused_linearize(xs, aux)[1]
