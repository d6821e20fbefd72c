"""Cost weights: sqrt-precision factors applied to errors and jacobians (JAX counterpart: theseus_tpu/core/cost_weight.py).

Weights apply to whole buckets at once (`apply_batched`, over leading
(K, B) dims); their parameters are aux variables.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .variable import Variable, as_variable


class CostWeight:
    """Base: subclasses define aux_vars and the batched transform."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{type(self).__name__}_{id(self)}"

    @property
    def aux_vars(self) -> Tuple[Variable, ...]:
        return ()

    def schema(self):
        return (type(self).__name__,)

    def apply_batched(self, err, jacs, waux):
        """err (K, B, dim), jacs list of (K, B, dim, dof) or None, waux tuple
        of aux arrays ((K, B, ...) or shared (B, ...)). Returns
        (weighted_err, weighted_jacs)."""
        raise NotImplementedError

    def is_zero(self, waux):
        """Boolean indicator of fully-zero weights, broadcastable against
        the leading dims of the weighted error; None = cannot tell."""
        return None


class ScaleCostWeight(CostWeight):
    """Scalar scale."""

    def __init__(self, scale=1.0, name: Optional[str] = None):
        super().__init__(name)
        v = as_variable(scale)
        if v.tensor.ndim == 0:
            v.tensor = v.tensor.reshape(1, 1)
        elif v.tensor.ndim == 1:
            v.tensor = v.tensor.reshape(-1, 1)
        self.scale = v

    @property
    def aux_vars(self):
        return (self.scale,)

    def apply_batched(self, err, jacs, waux):
        (s,) = waux  # (K, B, 1) or (B, 1); right-aligned broadcasting
        werr = err * s
        wjacs = None if jacs is None else [j * s[..., None] for j in jacs]
        return werr, wjacs

    def is_zero(self, waux):
        (s,) = waux
        return s[..., 0] == 0


class DiagonalCostWeight(CostWeight):
    """Per-dim diagonal weight."""

    def __init__(self, diagonal, name: Optional[str] = None):
        super().__init__(name)
        v = as_variable(diagonal)
        if v.tensor.ndim == 1:
            v.tensor = v.tensor[None]
        self.diagonal = v

    @property
    def aux_vars(self):
        return (self.diagonal,)

    def apply_batched(self, err, jacs, waux):
        (d,) = waux
        werr = err * d
        wjacs = None if jacs is None else [j * d[..., None] for j in jacs]
        return werr, wjacs

    def is_zero(self, waux):
        (d,) = waux  # zero only if every diagonal entry is zero
        return torch.all(d == 0, dim=-1)
