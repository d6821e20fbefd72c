"""Objective, variables, costs and weights (JAX counterpart: theseus_tpu/core/__init__.py)."""

from .compiled import CompiledObjective, compile_objective
from .cost_function import AutoDiffCostFunction, CostFunction, GNCRobustCostFunction, RobustCostFunction
from .cost_weight import CostWeight, DiagonalCostWeight, ScaleCostWeight
from .family import CostFamily, Point3Family, SE3Family, VariableFamily, VectorFamily
from .objective import Objective
from .robust_loss import GemanMcClureLoss, HingeLoss, HuberLoss, WelschLoss
from .variable import SE3, ManifoldVariable, Point3, Variable, Vector, as_variable

__all__ = [
    "CompiledObjective",
    "compile_objective",
    "CostFunction",
    "AutoDiffCostFunction",
    "RobustCostFunction",
    "GNCRobustCostFunction",
    "WelschLoss",
    "HuberLoss",
    "HingeLoss",
    "GemanMcClureLoss",
    "CostWeight",
    "CostFamily",
    "VariableFamily",
    "SE3Family",
    "Point3Family",
    "VectorFamily",
    "DiagonalCostWeight",
    "ScaleCostWeight",
    "Objective",
    "SE3",
    "Point3",
    "Vector",
    "ManifoldVariable",
    "Variable",
    "as_variable",
]
