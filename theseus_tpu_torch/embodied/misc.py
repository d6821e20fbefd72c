"""Local (a.k.a. Difference) prior cost (JAX counterpart: theseus_tpu/embodied/misc.py).

residual = log(target^{-1} var); analytic jacobian (wrt var) = jlog of the
difference.
"""

from __future__ import annotations

from typing import Optional

from ..core.cost_function import CostFunction
from ..core.cost_weight import CostWeight
from ..core.variable import ManifoldVariable, as_variable


class Local(CostFunction):
    has_analytic_jacobians = True

    def __init__(
        self,
        var: ManifoldVariable,
        target,
        cost_weight: Optional[CostWeight] = None,
        name: Optional[str] = None,
    ):
        target = as_variable(target)
        super().__init__([var], [target], cost_weight, name)
        self.group = var.group

    def dim(self):
        return self.group.dof

    def error_impl(self, optim, aux):
        (var,) = optim
        (target,) = aux
        return self.group.local(target, var)

    def jacobians_impl(self, optim, aux):
        (var,) = optim
        (target,) = aux
        g = self.group
        (jl,), res = g.jlog(g.between(target, var))
        return [jl], res


Difference = Local
