"""theseus_tpu_torch: the PyTorch / CUDA port of theseus_tpu (JAX counterpart: theseus_tpu/__init__.py).

Differentiable nonlinear least squares on an NVIDIA Hopper GPU. This first
slice covers the batched SE3 pose-graph forward solve: Between and Local
costs, Levenberg-Marquardt / Gauss-Newton over the level-scheduled
block-sparse Cholesky, and `TheseusLayer.forward`. Its four kernel families
(Between linearization, block assembly, level factorization, level
substitution) are hand-written CUDA kernels under `csrc/`, built with nvcc
at first use; on CPU tensors each runs its plain PyTorch twin.

This package imports torch and never jax.
"""

from . import config, lie
from .core import (
    SE3,
    CostFunction,
    CostWeight,
    DiagonalCostWeight,
    ManifoldVariable,
    Objective,
    ScaleCostWeight,
    Variable,
)
from .embodied import Between, Difference, Local
from .layer import TheseusLayer
from .optim import GaussNewton, LevenbergMarquardt, NLSOptions, OptimizerInfo

__all__ = [
    "config",
    "lie",
    "SE3",
    "CostFunction",
    "CostWeight",
    "DiagonalCostWeight",
    "ManifoldVariable",
    "Objective",
    "ScaleCostWeight",
    "Variable",
    "Between",
    "Difference",
    "Local",
    "TheseusLayer",
    "GaussNewton",
    "LevenbergMarquardt",
    "NLSOptions",
    "OptimizerInfo",
]
