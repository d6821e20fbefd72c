"""Objective, variables, costs and weights (JAX counterpart: theseus_tpu/core/__init__.py)."""

from .compiled import CompiledObjective, compile_objective
from .cost_function import AutoDiffCostFunction, CostFunction, GNCRobustCostFunction, RobustCostFunction
from .cost_weight import CostWeight, DiagonalCostWeight, ScaleCostWeight
from .family import (
    CostFamily,
    Point2Family,
    Point3Family,
    SE2Family,
    SE3Family,
    SO2Family,
    SO3Family,
    VariableFamily,
    VectorFamily,
)
from .objective import Objective
from .robust_loss import GemanMcClureLoss, HingeLoss, HuberLoss, WelschLoss
from .variable import SE2, SE3, SO2, SO3, ManifoldVariable, Point2, Point3, Variable, Vector, as_variable

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
    "SO3Family",
    "SE2Family",
    "SO2Family",
    "Point2Family",
    "Point3Family",
    "VectorFamily",
    "DiagonalCostWeight",
    "ScaleCostWeight",
    "Objective",
    "SE3",
    "SO3",
    "SE2",
    "SO2",
    "Point2",
    "Point3",
    "Vector",
    "ManifoldVariable",
    "Variable",
    "as_variable",
]
