"""theseus_tpu_torch: the PyTorch / CUDA port of theseus_tpu (JAX counterpart: theseus_tpu/__init__.py).

Differentiable nonlinear least squares on an NVIDIA Hopper GPU. Two problem
families are ported: the batched SE3 pose graph (Between and Local costs
over the level-scheduled block-sparse Cholesky) and bundle adjustment
(Reprojection cost families over SE3 cameras and Point3 landmarks, with the
Schur-complement backend, `linearization="schur"`), both by
Levenberg-Marquardt / Gauss-Newton through `TheseusLayer.forward`, both
differentiable in the four backward modes (unroll, implicit, truncated,
DLM), with robust losses on any cost. Their
kernels (Between and Reprojection linearization, block assembly, level
factorization, level substitution) are hand-written CUDA kernels under
`csrc/`, built with nvcc at first use; on CPU tensors each runs its plain
PyTorch twin.

This package imports torch and never jax.
"""

from . import config, lie
from .core import (
    SE3,
    CostFamily,
    CostFunction,
    CostWeight,
    DiagonalCostWeight,
    GemanMcClureLoss,
    GNCRobustCostFunction,
    HingeLoss,
    HuberLoss,
    ManifoldVariable,
    Objective,
    Point3,
    Point3Family,
    RobustCostFunction,
    ScaleCostWeight,
    SE3Family,
    Variable,
    VariableFamily,
    Vector,
    VectorFamily,
    WelschLoss,
)
from .embodied import Between, Difference, Local, Reprojection
from .layer import TheseusLayer
from .optim import GaussNewton, LevenbergMarquardt, NLSOptions, OptimizerInfo

__all__ = [
    "config",
    "lie",
    "SE3",
    "Point3",
    "Vector",
    "CostFamily",
    "VariableFamily",
    "SE3Family",
    "Point3Family",
    "VectorFamily",
    "CostFunction",
    "RobustCostFunction",
    "GNCRobustCostFunction",
    "WelschLoss",
    "HuberLoss",
    "HingeLoss",
    "GemanMcClureLoss",
    "CostWeight",
    "DiagonalCostWeight",
    "ManifoldVariable",
    "Objective",
    "ScaleCostWeight",
    "Variable",
    "Between",
    "Difference",
    "Local",
    "Reprojection",
    "TheseusLayer",
    "GaussNewton",
    "LevenbergMarquardt",
    "NLSOptions",
    "OptimizerInfo",
]
