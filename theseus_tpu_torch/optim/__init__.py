"""Optimizers, the elimination ordering and the normal-equation system (JAX counterpart: theseus_tpu/optim/__init__.py)."""

from .nonlinear import (
    Dogleg,
    GaussNewton,
    LevenbergMarquardt,
    LinearOptimizer,
    NLSOptions,
    NonlinearLeastSquares,
    NonlinearOptimizerStatus,
    OptimizerInfo,
)
from .linear import DenseCholeskySolver, DenseLUSolver
from .normal import (
    BlockNormal,
    BlockNormalBuilder,
    DenseNormal,
    DenseNormalBuilder,
    SparseNormal,
    SparseNormalBuilder,
)
from .ordering import VariableOrdering
from .schur import SchurNormal, SchurNormalBuilder, eliminate_points

__all__ = [
    "Dogleg",
    "GaussNewton",
    "LevenbergMarquardt",
    "LinearOptimizer",
    "NLSOptions",
    "NonlinearLeastSquares",
    "NonlinearOptimizerStatus",
    "OptimizerInfo",
    "DenseCholeskySolver",
    "DenseLUSolver",
    "DenseNormal",
    "DenseNormalBuilder",
    "BlockNormal",
    "BlockNormalBuilder",
    "SparseNormal",
    "SparseNormalBuilder",
    "SchurNormal",
    "SchurNormalBuilder",
    "eliminate_points",
    "VariableOrdering",
]
