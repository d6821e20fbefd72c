"""Utilities: problem conversion, jacobian checks, timing, image warps, sparse helpers, checkpoints and example problems (JAX counterpart: theseus_tpu/utils/__init__.py).

The JAX package's `hoist` and `host` modules have no counterpart: they
exist only for XLA's compilation and the TPU's host transfers.
"""

from . import examples
from .checks import (
    autodiff_jacobian,
    build_mlp,
    check_jacobians,
    gather_from_rows_cols,
    numeric_jacobian,
)
from .timer import Profiler, Timer, device_sync, fresh_eps
