"""Unrolled small-matrix linear algebra, d <= 8 (JAX counterpart: theseus_tpu/ops/batched_linalg.py).

These are the arithmetic models of the factor and substitution kernels'
plain twins, and the landmark solves of the Schur backend: the d loop is
unrolled in Python, so every step is one elementwise op over the leading
batch dims, in the same order as the CUDA kernels. A non-positive pivot
yields NaN (sqrt of a negative number) rather than an exception, as in the
kernels and in the JAX package.
"""

from __future__ import annotations

import torch

SMALL_DIM_MAX = 8


def chol_small(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., d, d) SPD, unrolled Cholesky-Crout. Returns lower L;
    reads the lower triangle only."""
    d = a.shape[-1]
    l = [[None] * d for _ in range(d)]
    for j in range(d):
        s = a[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        ljj = torch.sqrt(s)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, d):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    zero = torch.zeros_like(a[..., 0, 0])
    rows = [
        torch.stack([l[i][j] if j <= i else zero for j in range(d)], dim=-1)
        for i in range(d)
    ]
    return torch.stack(rows, dim=-2)


def solve_lower_vec(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L y = b with L (..., d, d) lower, b (..., d) -> y (..., d)."""
    d = l.shape[-1]
    ys = []
    for i in range(d):
        s = b[..., i]
        for k in range(i):
            s = s - l[..., i, k] * ys[k]
        ys.append(s / l[..., i, i])
    return torch.stack(ys, dim=-1)


def solve_lower_mat(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L Y = B with L (..., d, d) lower and B (..., d, k): unrolled rows,
    broadcast over the k columns."""
    d = l.shape[-1]
    ys = []
    for i in range(d):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[..., i, k, None] * ys[k]
        ys.append(s / l[..., i, i, None])
    return torch.stack(ys, dim=-2)


def solve_upper_vec(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """U x = b with U (..., d, d) upper, b (..., d) -> x (..., d)."""
    d = u.shape[-1]
    xs = [None] * d
    for i in reversed(range(d)):
        s = b[..., i]
        for k in range(i + 1, d):
            s = s - u[..., i, k] * xs[k]
        xs[i] = s / u[..., i, i]
    return torch.stack(xs, dim=-1)


def chol_solve_vec(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T) x = b for L (..., d, d) lower, b (..., d)."""
    return solve_upper_vec(l.transpose(-1, -2), solve_lower_vec(l, b))


def chol_solve_mat(l: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(L L^T) X = M for M (..., d, k), one column solve per column of M
    (the JAX package vmaps `chol_solve_vec` over the columns; here the
    column axis rides along as a batch axis)."""
    cols = chol_solve_vec(l[..., None, :, :], m.transpose(-1, -2))  # (..., k, d)
    return cols.transpose(-1, -2)


def rt_solve_lower(l: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """X = C @ L^{-T} for C (..., k, d): solve X L^T = C row-wise,
    x_j = (c_j - sum_{m<j} x_m L[j, m]) / L[j, j]."""
    d = l.shape[-1]
    xs = []
    for j in range(d):
        s = c[..., :, j]
        for m in range(j):
            s = s - xs[m] * l[..., None, j, m]
        xs.append(s / l[..., None, j, j])
    return torch.stack(xs, dim=-1)
