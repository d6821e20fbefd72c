"""Measurement cost functions: Between (JAX counterpart: theseus_tpu/embodied/measurements.py).

residual = log(measurement^{-1} (v1^{-1} v2)), the PGO workhorse, with
analytic jacobians J2 = jlog(m^{-1} d), J1 = -J2 Adj(d^{-1}),
d = v1^{-1} v2. For SE3 the whole bucket goes through the fused
linearization (ops/between_se3.py): the CUDA kernel on the card, its plain
twin on the CPU.
"""

from __future__ import annotations

from typing import Optional

from ..core.cost_function import CostFunction
from ..core.cost_weight import CostWeight
from ..core.variable import ManifoldVariable, as_variable


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
        Returns ((j1, j2), err) of shapes (K, B, 6, 6) / (K, B, 6)."""
        from ..ops.between_se3 import between_linearize

        v1, v2 = xs
        (meas,) = aux
        j1, j2, err = between_linearize(v1, v2, meas)
        return (j1, j2), err

    def fused_error(self, xs, aux):
        """Error-only evaluation through the same fused kernel."""
        return self.fused_linearize(xs, aux)[1]
