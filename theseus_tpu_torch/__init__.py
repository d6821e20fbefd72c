"""theseus_tpu_torch: the PyTorch / CUDA port of theseus_tpu (JAX counterpart: theseus_tpu/__init__.py).

Differentiable nonlinear least squares on an NVIDIA Hopper GPU, by
Levenberg-Marquardt / Gauss-Newton through `TheseusLayer.forward`,
differentiable in the four backward modes (unroll, implicit, truncated,
DLM), with robust losses on any cost. Three linearizations: "dense" (the
default, as in the JAX package: a dense jacobian and a batched Cholesky),
"sparse" (block-sparse: Between and Local costs over SE3 or SE2 poses through the
level-scheduled block-sparse Cholesky) and "schur" (bundle adjustment:
Reprojection cost families over SE3 cameras and Point3 landmarks). Costs
have analytic jacobians or are `AutoDiffCostFunction`s, differentiated by
torch.func; `kin` holds URDF forward kinematics (the inverse-kinematics
serving path). Variables live on SO2, SE2, SO3, SE3 or R^n (`lie`), with
the functional API (`compose`, `between`, `rand_se2`, ...) and the
lie-group checks of the JAX package. Their
kernels (Between and Reprojection linearization, block assembly, level
factorization, level substitution) are hand-written CUDA kernels under
`csrc/`, built with nvcc at first use; on CPU tensors each runs its plain
PyTorch twin.

This package imports torch and never jax.
"""

from . import config, lie
from . import kin
from .core import (
    SE2,
    SE3,
    SO2,
    SO3,
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
    Point2,
    Point2Family,
    Point3,
    Point3Family,
    RobustCostFunction,
    ScaleCostWeight,
    SE2Family,
    SE3Family,
    SO2Family,
    SO3Family,
    Variable,
    VariableFamily,
    Vector,
    VectorFamily,
    WelschLoss,
    as_variable,
)
from .core.functional import (
    adjoint,
    between,
    compose,
    exp_map,
    inverse,
    local,
    log_map,
    rand_point2,
    rand_point3,
    rand_se2,
    rand_se3,
    rand_so2,
    rand_so3,
    rand_vector,
    randn_point2,
    randn_point3,
    randn_se2,
    randn_se3,
    randn_so2,
    randn_so3,
    randn_vector,
    retract,
)
from .config import set_global_params
from .lie.checks import enable_lie_group_check, no_lie_group_check, set_lie_group_check_enabled
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
    "set_global_params",
    "SE3",
    "SO3",
    "SE2",
    "SO2",
    "Point2",
    "Point3",
    "Vector",
    "CostFamily",
    "VariableFamily",
    "SE3Family",
    "SO3Family",
    "SE2Family",
    "SO2Family",
    "Point2Family",
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
    "as_variable",
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
    "compose",
    "between",
    "inverse",
    "log_map",
    "exp_map",
    "adjoint",
    "local",
    "retract",
    "rand_so2",
    "randn_so2",
    "rand_se2",
    "randn_se2",
    "rand_so3",
    "randn_so3",
    "rand_se3",
    "randn_se3",
    "rand_point2",
    "randn_point2",
    "rand_point3",
    "randn_point3",
    "rand_vector",
    "randn_vector",
    "enable_lie_group_check",
    "no_lie_group_check",
    "set_lie_group_check_enabled",
]
