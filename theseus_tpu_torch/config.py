"""Global numeric configuration for theseus_tpu_torch (JAX counterpart: theseus_tpu/config.py).

Holds the per-dtype eps tables that switch the Lie-group Taylor branches, the
solver-precision settings, and the kernel dispatch rule of the port:

- a tensor on a CUDA device goes to the hand-written kernel, whatever its
  floating dtype (the kernels are templates over float and double);
- a tensor on the CPU goes to the kernel's plain PyTorch twin.

There is no dtype gate, no size gate and no fallback around a build or a
launch: a kernel that cannot build or launch raises. The one way to run a
twin on the card is the explicit `plain_path()` context, which comparison
harnesses use to build the reference they hold the kernels against.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

# Matmul precision for solver-critical paths. A reduced-precision matmul pass
# (bf16 on the TPU, TF32 on Hopper) drops the digits J^T J assembly and the
# Cholesky updates need; on the TPU it broke LM convergence. Pin full float32
# once, for the whole process, before any solve runs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


# Branch-switch thresholds, keyed "<name>_<dtype>" exactly as in the JAX
# package (reference torchlie/torchlie/global_params.py:36-63).
_DEFAULTS: Dict[str, float] = {
    # SO3/SE3 exp near-zero (theta small)
    "so3_near_zero_eps_float32": 1e-2,
    "so3_near_zero_eps_float64": 5e-3,
    # SO3/SE3 log near-pi (1 + cos(theta) small)
    "so3_near_pi_eps_float32": 1e-2,
    "so3_near_pi_eps_float64": 1e-7,
    # wider derivative branch eps (jlog coefficients)
    "so3_d_near_zero_eps_float32": 2e-1,
    "so3_d_near_zero_eps_float64": 1e-2,
    # SO3 matrix orthonormality check tolerance
    "so3_matrix_eps_float32": 4e-4,
    "so3_matrix_eps_float64": 1e-6,
    "so3_quat_eps_float32": 2e-4,
    "so3_quat_eps_float64": 5e-7,
    "so3_hat_eps_float32": 5e-6,
    "so3_hat_eps_float64": 5e-7,
    "se3_hat_eps_float32": 5e-6,
    "se3_hat_eps_float64": 5e-7,
    # SO2/SE2 near-zero
    "se2_near_zero_eps_float32": 3e-2,
    "se2_near_zero_eps_float64": 1e-6,
    "se2_d_near_zero_eps_float32": 1e-1,
    "se2_d_near_zero_eps_float64": 1e-3,
}

_VALUES: Dict[str, float] = dict(_DEFAULTS)


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32" (the key suffix of the eps table)."""
    return str(dtype).rsplit(".", 1)[-1]


def get_eps(namespace: str, name: str, dtype: torch.dtype) -> float:
    """Fetch eps, e.g. get_eps("so3", "near_zero", x.dtype)."""
    return _VALUES[f"{namespace}_{name}_eps_{dtype_name(dtype)}"]


def set_global_params(**kwargs: float) -> None:
    for k, v in kwargs.items():
        if k not in _VALUES:
            raise ValueError(f"Unknown global param {k}")
        _VALUES[k] = float(v)


# ---------------------------------------------------------------------------
# High-precision accumulation tier. The JAX package turns it on exactly when
# the process runs with x64 enabled (sparse/refine.py hp_dtype): Atb is then
# accumulated in float64 and each normal-equation solve gets REFINE_STEPS
# sweeps of mixed-precision iterative refinement. bench.py runs without x64,
# so its solves have the tier off. Here the tier is one explicit setting with
# the same meaning; the default, False, matches bench.py. A float64 solve
# never needs it (its own dtype is already the high-precision one).
# ---------------------------------------------------------------------------
HIGH_PRECISION_TIER = False
REFINE_STEPS = 1
ATB_HIGH_PRECISION = True


def set_high_precision_tier(enabled: bool) -> None:
    global HIGH_PRECISION_TIER
    HIGH_PRECISION_TIER = bool(enabled)


def set_refine_steps(n: int) -> None:
    global REFINE_STEPS
    REFINE_STEPS = int(n)


def set_atb_high_precision(enabled: bool) -> None:
    global ATB_HIGH_PRECISION
    ATB_HIGH_PRECISION = bool(enabled)


# ---------------------------------------------------------------------------
# Dense-tail amalgamation thresholds. They feed the symbolic analysis
# (sparse/structure.py) so that its tables equal the JAX package's; the
# numeric dense tail itself is not ported yet (see ROADMAP.md), and a
# schedule that has one raises.
# ---------------------------------------------------------------------------
SPARSE_DENSE_TAIL = True
SPARSE_TAIL_DENSITY = 0.6
SPARSE_TAIL_MAX_DIM = 2048
SPARSE_TAIL_MIN_K = 16


def set_sparse_dense_tail(enabled: bool) -> None:
    global SPARSE_DENSE_TAIL
    SPARSE_DENSE_TAIL = bool(enabled)


# ---------------------------------------------------------------------------
# Kernel dispatch (replaces the JAX package's `pallas_enabled`).
# ---------------------------------------------------------------------------
_PLAIN = False


@contextlib.contextmanager
def plain_path():
    """Route CUDA tensors to the plain twins inside this block.

    Only for building a reference to compare the kernels with (chip_smoke.py
    and the CUDA tests); nothing in the solver enters it on its own."""
    global _PLAIN
    prev = _PLAIN
    _PLAIN = True
    try:
        yield
    finally:
        _PLAIN = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel. False: run the plain twin (CPU tensor,
    or inside `plain_path()`). Any other device raises."""
    if t.device.type == "cuda":
        return not _PLAIN
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(
        f"theseus_tpu_torch runs on CUDA or CPU tensors, got {t.device}"
    )


def check_no_grad(*tensors: torch.Tensor) -> None:
    """The port solves forward only for now (backward modes are the next
    step of ROADMAP.md): refuse inputs that carry autograd history instead
    of detaching them silently."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise NotImplementedError(
            "theseus_tpu_torch has no backward pass yet (ROADMAP.md, queue 1):"
            " pass tensors that do not require grad"
        )
