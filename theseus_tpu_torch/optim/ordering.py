"""Elimination ordering of the block-sparse solver (JAX counterpart: theseus_tpu/optim/ordering.py).

An ordering is a strategy string ("auto" | "nd" | "amd" | "rcm" |
"natural"), a `VariableOrdering`, an explicit permutation array, or a
sequence of variable names in elimination order. "auto" symbolically
factors with each candidate strategy and keeps the one with the lowest
modelled device cost (sparse/structure.py symbolic_factor_auto).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from ..sparse.structure import SymbolicFactor, symbolic_factor, symbolic_factor_auto


class VariableOrdering:
    """An ordered list of optimization-variable names, by default the
    objective's insertion order. Passed as `ordering=` to an optimizer or a
    `SparseNormalBuilder`, it is the block solver's elimination order."""

    def __init__(self, objective=None, default_order: bool = True,
                 names: Optional[Sequence[str]] = None):
        self.objective = objective
        self._names: List[str] = []
        if names is not None:
            for n in names:
                self.append(n)
        elif objective is not None and default_order:
            self._names.extend(objective.optim_vars.keys())

    def append(self, name: str) -> None:
        if name in self._names:
            raise ValueError(f"variable {name} already in ordering")
        if self.objective is not None and name not in self.objective.optim_vars:
            raise ValueError(f"variable {name} not in objective")
        self._names.append(name)

    def remove(self, name: str) -> None:
        self._names.remove(name)

    def extend(self, names: Iterable[str]) -> None:
        for n in names:
            self.append(n)

    def index_of(self, name: str) -> int:
        return self._names.index(name)

    @property
    def complete(self) -> bool:
        if self.objective is None:
            return True
        return set(self._names) == set(self.objective.optim_vars.keys())

    def __getitem__(self, i: int) -> str:
        return self._names[i]

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def names(self) -> List[str]:
        return list(self._names)

    def as_permutation(self, var_names: Sequence[str]) -> np.ndarray:
        """perm[k] = index (into var_names, the compiled objective's column
        order) of the k-th variable to eliminate."""
        index = {n: i for i, n in enumerate(var_names)}
        missing = [n for n in self._names if n not in index]
        if missing:
            raise ValueError(f"ordering names not in objective: {missing}")
        if len(self._names) != len(var_names):
            raise ValueError(f"ordering is incomplete: {len(self._names)} of {len(var_names)} variables")
        return np.array([index[n] for n in self._names], dtype=np.int64)


OrderingSpec = Union[str, VariableOrdering, Sequence[str], np.ndarray]


def resolve_ordering(ordering: OrderingSpec, var_names: Sequence[str]):
    """Normalize to what `symbolic_factor` accepts: a strategy string or an
    explicit permutation (perm[k] = index of the k-th eliminated var)."""
    if isinstance(ordering, str):
        return ordering
    if isinstance(ordering, VariableOrdering):
        return ordering.as_permutation(var_names)
    if isinstance(ordering, np.ndarray):
        return np.asarray(ordering, dtype=np.int64)
    return VariableOrdering(names=list(ordering)).as_permutation(var_names)


def symbolic_for(pattern, ordering: OrderingSpec, var_names: Sequence[str]) -> SymbolicFactor:
    ordering = resolve_ordering(ordering, var_names)
    if isinstance(ordering, str) and ordering == "auto":
        return symbolic_factor_auto(pattern.n_vars, pattern.pairs, pattern.d)
    return symbolic_factor(pattern.n_vars, pattern.pairs, pattern.d, ordering)
