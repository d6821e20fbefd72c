"""theseus_tpu_torch: the PyTorch / CUDA port of theseus_tpu (JAX counterpart: theseus_tpu/__init__.py).

Differentiable nonlinear least squares on an NVIDIA Hopper GPU, by
Levenberg-Marquardt / Gauss-Newton through `TheseusLayer.forward`,
differentiable in the four backward modes (unroll, implicit, truncated,
DLM), with robust losses on any cost. Three linearizations: "dense" (the
default, as in the JAX package: a dense jacobian and a batched Cholesky),
"sparse" (the batched SE3 pose graph's Between and Local costs over the
level-scheduled block-sparse Cholesky) and "schur" (bundle adjustment:
Reprojection cost families over SE3 cameras and Point3 landmarks). Costs
have analytic jacobians or are `AutoDiffCostFunction`s, differentiated by
torch.func; `kin` holds URDF forward kinematics (the inverse-kinematics
serving path). Their
kernels (Between and Reprojection linearization, block assembly, level
factorization, level substitution) are hand-written CUDA kernels under
`csrc/`, built with nvcc at first use; on CPU tensors each runs its plain
PyTorch twin.

This package imports torch and never jax.
"""

from . import config, lie
from . import kin
from .core import (
    SE3,
    AutoDiffCostFunction,
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
from .optim import (
    DenseCholeskySolver,
    DenseLUSolver,
    GaussNewton,
    LevenbergMarquardt,
    NLSOptions,
    NonlinearOptimizerStatus,
    OptimizerInfo,
)

__all__ = [
    "config",
    "kin",
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
    "AutoDiffCostFunction",
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
    "NonlinearOptimizerStatus",
    "OptimizerInfo",
    "DenseCholeskySolver",
    "DenseLUSolver",
]
