"""Variables: named handles binding a manifold type (or raw tensor) to data (JAX counterpart: theseus_tpu/core/variable.py).

A Variable is a spec (name + group + default value); per-solve data flows as
a plain `{name: (B, *shape)}` dict. Values are stored as given (a numpy array
or a torch tensor): converting host data here would cost one device copy per
variable, so the compiled objective converts whole stacks at pack/build_aux
time, once, to the objective's device and dtype.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..lie import Group
from ..lie import group as _groupmod

_counter = itertools.count()


def _auto_name(prefix: str) -> str:
    return f"{prefix}__{next(_counter)}"


class Variable:
    """An auxiliary (non-optimized) named tensor of shape (B, *shape)."""

    def __init__(self, tensor=None, name: Optional[str] = None):
        self.name = name or _auto_name(type(self).__name__)
        if tensor is None or isinstance(tensor, (np.ndarray, torch.Tensor)):
            self.tensor = tensor
        else:
            self.tensor = np.asarray(tensor)

    @property
    def shape(self):
        return None if self.tensor is None else tuple(self.tensor.shape)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name}, shape={self.shape})"


class ManifoldVariable(Variable):
    """An optimization variable living on a manifold `group`."""

    def __init__(self, group: Group, tensor=None, name: Optional[str] = None):
        super().__init__(tensor=tensor, name=name)
        self.group = group
        if self.tensor is not None:
            expect = group.shape
            if tuple(self.tensor.shape[-len(expect):]) != tuple(expect):
                raise ValueError(
                    f"{group.name} variable expects trailing shape {expect}, "
                    f"got {tuple(self.tensor.shape)}"
                )
            if self.tensor.ndim == len(expect):
                self.tensor = self.tensor[None]  # add batch dim

    @property
    def dof(self) -> int:
        return self.group.dof

    def default(self, dtype: torch.dtype, device):
        if self.tensor is not None:
            return self.tensor
        return self.group.identity(1, dtype=dtype, device=device)


def SE3(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return ManifoldVariable(_groupmod.SE3, tensor, name)


def as_variable(value, name: Optional[str] = None) -> Variable:
    """Wrap raw data as an aux Variable. Python scalars become float64 numpy
    0-d arrays; build_aux casts floating aux to the objective dtype."""
    if isinstance(value, Variable):
        return value
    if not isinstance(value, (np.ndarray, torch.Tensor)):
        value = np.asarray(value)
    return Variable(tensor=value, name=name)
