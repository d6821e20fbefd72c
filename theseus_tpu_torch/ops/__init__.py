"""Fused geometric kernels and small linear algebra (JAX counterpart: theseus_tpu/ops/__init__.py)."""

from .batched_linalg import (
    SMALL_DIM_MAX,
    chol_small,
    rt_solve_lower,
    solve_lower_mat,
    solve_lower_vec,
    solve_upper_vec,
)
