"""Objective, variables, costs and weights (JAX counterpart: theseus_tpu/core/__init__.py)."""

from .compiled import CompiledObjective, compile_objective
from .cost_function import CostFunction
from .cost_weight import CostWeight, DiagonalCostWeight, ScaleCostWeight
from .objective import Objective
from .variable import SE3, ManifoldVariable, Variable, as_variable

__all__ = [
    "CompiledObjective",
    "compile_objective",
    "CostFunction",
    "CostWeight",
    "DiagonalCostWeight",
    "ScaleCostWeight",
    "Objective",
    "SE3",
    "ManifoldVariable",
    "Variable",
    "as_variable",
]
