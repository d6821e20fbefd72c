"""Optimizers (Gauss-Newton, LM, Dogleg, DCEM, Gaussian belief propagation), the elimination ordering and the normal-equation system (JAX counterpart: theseus_tpu/optim/__init__.py)."""

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
from .linear import DenseCholeskySolver, DenseLUSolver, apply_damping
from .dcem import DCEM, DCEMOptions
from .gaussian import ManifoldGaussian, local_gaussian, retract_gaussian
from .gbp import GaussianBeliefPropagation, GBPOptions
from .lml import lml
from .manifold_optax import lie_optimizer, manifold_update
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
    "DCEM",
    "DCEMOptions",
    "ManifoldGaussian",
    "local_gaussian",
    "retract_gaussian",
    "GaussianBeliefPropagation",
    "GBPOptions",
    "lml",
    "lie_optimizer",
    "manifold_update",
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
    "apply_damping",
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
