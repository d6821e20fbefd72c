"""Sparse-matrix utilities: batched CSR matvecs and random test problems (JAX counterpart: theseus_tpu/utils/sparse_utils.py).

A CSR structure (row_ptr, col_ind) is static and shared by the batch; the
values are batched, (B, nnz). A matvec is a gather of v at the column (or
row) of every stored entry, a product with the values, and one
`index_add_` into the output rows, differentiable by autograd in the
values and the vector.
"""

from __future__ import annotations

import numpy as np
import torch


def _row_of(row_ptr) -> np.ndarray:
    row_ptr = np.asarray(row_ptr)
    return np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def mat_vec(num_cols: int, row_ptr, col_ind, val: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched CSR A @ v: val (B, nnz), v (B, num_cols) -> (B, m)."""
    m = len(row_ptr) - 1
    prod = val * v[:, _index(col_ind, v.device)]
    out = torch.zeros((val.shape[0], m), dtype=prod.dtype, device=prod.device)
    return out.index_add(1, _index(_row_of(row_ptr), v.device), prod)


def tmat_vec(num_cols: int, row_ptr, col_ind, val: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched CSR A^T @ v: val (B, nnz), v (B, m) -> (B, num_cols)."""
    prod = val * v[:, _index(_row_of(row_ptr), v.device)]
    out = torch.zeros((val.shape[0], num_cols), dtype=prod.dtype, device=prod.device)
    return out.index_add(1, _index(col_ind, v.device), prod)


# differentiable aliases: autograd differentiates the gather and index_add
sparse_mv = mat_vec
sparse_mtv = tmat_vec


def random_sparse_binary_matrix(rows: int, cols: int, fill: float, min_entries_per_col: int, rng=None,
                                generator: torch.Generator = None):
    """A random sparse binary CSR matrix (scipy.sparse.csr_matrix): at least
    min_entries_per_col ones in every column, plus int(fill * rows * cols)
    ones at random positions. The draws come from `rng` (a numpy
    RandomState: the same matrix as the JAX package's for the same state),
    else from `generator` (a torch.Generator), else from RandomState(0)."""
    import scipy.sparse as sp

    retv = sp.lil_matrix((rows, cols))
    n_extra = int(fill * rows * cols)
    if rng is None and generator is not None:
        k = min(min_entries_per_col, rows)
        draw = lambda t: np.array(t.tolist(), dtype=np.int64)  # noqa: E731
        for c in range(cols if min_entries_per_col > 0 else 0):
            retv[draw(torch.randperm(rows, generator=generator)[:k]), c] = 1.0
        r = draw(torch.randint(0, rows, (n_extra,), generator=generator))
        retv[r, draw(torch.randint(0, cols, (n_extra,), generator=generator))] = 1.0
        return retv.tocsr()
    rng = rng or np.random.RandomState(0)
    if min_entries_per_col > 0:
        for c in range(cols):
            retv[rng.choice(rows, size=min(min_entries_per_col, rows), replace=False), c] = 1.0
    retv[rng.randint(0, rows, n_extra), rng.randint(0, cols, n_extra)] = 1.0
    return retv.tocsr()


def split_into_param_sizes(n: int, param_size_range_min: int, param_size_range_max: int, rng=None,
                           generator: torch.Generator = None) -> np.ndarray:
    """Split n columns into random variable-block sizes in
    [param_size_range_min, param_size_range_max] (the last one cut to fit).
    Draws as in `random_sparse_binary_matrix`."""
    if rng is None and generator is not None:
        draw = lambda: int(torch.randint(param_size_range_min, param_size_range_max + 1, (), generator=generator))  # noqa: E731
    else:
        rng = rng or np.random.RandomState(0)
        draw = lambda: int(rng.randint(param_size_range_min, param_size_range_max + 1))  # noqa: E731
    sizes = []
    left = n
    while left > 0:
        s = min(draw(), left)
        sizes.append(s)
        left -= s
    return np.asarray(sizes)
