"""Cost functions: weighted residual terms over manifold variables (JAX counterpart: theseus_tpu/core/cost_function.py).

The analytic-jacobian path only. `error_impl(optim, aux)` and
`jacobians_impl(optim, aux)` take whole stacked buckets: every optim operand
is (K, B, *shape) and every aux operand (K, B, ...) or, when all members of
the bucket share it, (B, ...); torch broadcasting does what the JAX
package's vmap over instances and batch did. Autodiff and robust costs are
not ported yet (ROADMAP.md, queue 1, slice 3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .cost_weight import CostWeight, ScaleCostWeight
from .variable import ManifoldVariable, Variable, as_variable


class CostFunction:
    """Base class. Subclasses define `dim`, `error_impl` and the analytic
    `jacobians_impl` (right-tangent jacobians)."""

    has_analytic_jacobians = False

    def __init__(
        self,
        optim_vars: Sequence[ManifoldVariable],
        aux_vars: Sequence[Variable] = (),
        cost_weight: Optional[CostWeight] = None,
        name: Optional[str] = None,
    ):
        if len(optim_vars) < 1:
            raise ValueError("At least one optimization variable is required.")
        for v in optim_vars:
            if not isinstance(v, ManifoldVariable):
                raise TypeError(f"Optim var {v} must be a ManifoldVariable.")
        self.optim_vars: Tuple[ManifoldVariable, ...] = tuple(optim_vars)
        self.aux_vars: Tuple[Variable, ...] = tuple(as_variable(a) for a in aux_vars)
        self.weight: CostWeight = cost_weight or ScaleCostWeight(1.0)
        self.name = name or f"{type(self).__name__}__{id(self)}"

    def dim(self) -> int:
        raise NotImplementedError

    def error_impl(self, optim: Tuple, aux: Tuple):
        """Stacked optim and aux operands -> (K, B, dim)."""
        raise NotImplementedError

    def jacobians_impl(self, optim: Tuple, aux: Tuple):
        """Returns (list over optim slots of (K, B, dim, dof), err (K, B, dim))."""
        raise NotImplementedError

    def schema(self):
        """Costs with equal schema are evaluated together as one bucket."""
        return (
            type(self).__name__,
            tuple(v.group.name for v in self.optim_vars),
            tuple(None if a.tensor is None else tuple(a.tensor.shape[1:]) for a in self.aux_vars),
            self.weight.schema(),
            self.dim(),
        )

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name}, dim={self.dim()})"
