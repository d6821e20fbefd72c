"""Elimination ordering of the block-sparse solver (JAX counterpart: theseus_tpu/optim/ordering.py).

An ordering is a strategy string ("auto" | "nd" | "amd" | "rcm" |
"natural"), an explicit permutation array, or a sequence of variable names
in elimination order. "auto" symbolically factors with each candidate
strategy and keeps the one with the lowest modelled device cost
(sparse/structure.py symbolic_factor_auto).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from ..sparse.structure import SymbolicFactor, symbolic_factor, symbolic_factor_auto

OrderingSpec = Union[str, Sequence[str], np.ndarray]


def resolve_ordering(ordering: OrderingSpec, var_names: Sequence[str]):
    """Normalize to what `symbolic_factor` accepts: a strategy string or an
    explicit permutation (perm[k] = index of the k-th eliminated var)."""
    if isinstance(ordering, str):
        return ordering
    if isinstance(ordering, np.ndarray):
        return np.asarray(ordering, dtype=np.int64)
    index = {n: i for i, n in enumerate(var_names)}
    names = list(ordering)
    missing = [n for n in names if n not in index]
    if missing:
        raise ValueError(f"ordering names not in objective: {missing}")
    if len(names) != len(var_names):
        raise ValueError(f"ordering is incomplete: {len(names)} of {len(var_names)} variables")
    return np.array([index[n] for n in names], dtype=np.int64)


def symbolic_for(pattern, ordering: OrderingSpec, var_names: Sequence[str]) -> SymbolicFactor:
    ordering = resolve_ordering(ordering, var_names)
    if isinstance(ordering, str) and ordering == "auto":
        return symbolic_factor_auto(pattern.n_vars, pattern.pairs, pattern.d)
    return symbolic_factor(pattern.n_vars, pattern.pairs, pattern.d, ordering)
