"""Optimizers and the normal-equation system (JAX counterpart: theseus_tpu/optim/__init__.py)."""

from .nonlinear import (
    GaussNewton,
    LevenbergMarquardt,
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
from .schur import SchurNormal, SchurNormalBuilder, eliminate_points

__all__ = [
    "GaussNewton",
    "LevenbergMarquardt",
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
]
