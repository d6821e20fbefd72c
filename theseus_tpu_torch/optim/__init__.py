"""Optimizers and the normal-equation system (JAX counterpart: theseus_tpu/optim/__init__.py)."""

from .nonlinear import (
    GaussNewton,
    LevenbergMarquardt,
    NLSOptions,
    NonlinearLeastSquares,
    NonlinearOptimizerStatus,
    OptimizerInfo,
)
from .normal import SparseNormal, SparseNormalBuilder

__all__ = [
    "GaussNewton",
    "LevenbergMarquardt",
    "NLSOptions",
    "NonlinearLeastSquares",
    "NonlinearOptimizerStatus",
    "OptimizerInfo",
    "SparseNormal",
    "SparseNormalBuilder",
]
