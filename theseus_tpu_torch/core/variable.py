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

from ..lie import Group, euclidean
from ..lie import group as _groupmod
from ..lie.checks import check_group

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
            check_group(group, self.tensor)

    @property
    def dof(self) -> int:
        return self.group.dof

    def default(self, dtype: torch.dtype, device):
        if self.tensor is not None:
            return self.tensor
        return self.group.identity(1, dtype=dtype, device=device)

    # -- the Euclidean arithmetic surface: Vector, Point2 and Point3 take
    # elementwise arithmetic and inner products and return new Euclidean
    # variables. numpy operands stay numpy, torch ones torch.
    @property
    def _is_euclidean(self) -> bool:
        return self.group.name.startswith("Rn")

    def _euclid_data(self, other):
        if not self._is_euclidean:
            raise TypeError(
                f"arithmetic is only defined for euclidean variables, not {self.group.name}; "
                "use the lie ops / LieArray API"
            )
        if isinstance(other, ManifoldVariable):
            if not other._is_euclidean:
                raise TypeError("cannot combine euclidean and Lie variables")
            other = other.tensor
        return self.tensor, other

    def _wrap(self, data):
        return ManifoldVariable(euclidean(int(data.shape[-1])), data)

    def __add__(self, other):
        a, b = self._euclid_data(other)
        return self._wrap(a + b)

    __radd__ = __add__

    def __sub__(self, other):
        a, b = self._euclid_data(other)
        return self._wrap(a - b)

    def __rsub__(self, other):
        a, b = self._euclid_data(other)
        return self._wrap(b - a)

    def __mul__(self, other):
        a, b = self._euclid_data(other)
        return self._wrap(a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        a, b = self._euclid_data(other)
        return self._wrap(a / b)

    def __neg__(self):
        a, _ = self._euclid_data(None)
        return self._wrap(-a)

    def __abs__(self):
        a, _ = self._euclid_data(None)
        return self._wrap(abs(a))

    def __matmul__(self, matrix):
        """(B, dof) @ (dof, k), or batched (B, dof, k)."""
        a, m = self._euclid_data(matrix)
        out = (a[:, None, :] @ m)[:, 0, :] if m.ndim == 3 else a @ m
        return self._wrap(out)

    def dot(self, other):
        """Batched inner product -> (B,)."""
        a, b = self._euclid_data(other)
        return (a * b).sum(-1)

    inner = dot

    def outer(self, other):
        """Batched outer product -> (B, dof, dof)."""
        a, b = self._euclid_data(other)
        return a[..., :, None] * b[..., None, :]

    def norm(self):
        a, _ = self._euclid_data(None)
        if isinstance(a, torch.Tensor):
            return torch.linalg.vector_norm(a, dim=-1)
        return np.linalg.norm(a, axis=-1)

    @staticmethod
    def cat(vectors, name: Optional[str] = None) -> "ManifoldVariable":
        """Concatenate Euclidean variables along the dof."""
        datas = [v.tensor if isinstance(v, ManifoldVariable) else v for v in vectors]
        if all(isinstance(d, np.ndarray) for d in datas):
            data = np.concatenate(datas, axis=-1)
        else:
            data = torch.cat([torch.as_tensor(d) for d in datas], dim=-1)
        return ManifoldVariable(euclidean(int(data.shape[-1])), data, name)

    # point accessors
    def x(self):
        return self.tensor[..., 0]

    def y(self):
        return self.tensor[..., 1]

    def z(self):
        if self.dof < 3:
            raise AttributeError("z() requires dof >= 3")
        return self.tensor[..., 2]


def SE3(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return ManifoldVariable(_groupmod.SE3, tensor, name)


def SO3(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return ManifoldVariable(_groupmod.SO3, tensor, name)


def SE2(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return ManifoldVariable(_groupmod.SE2, tensor, name)


def SO2(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return ManifoldVariable(_groupmod.SO2, tensor, name)


def Vector(dof: Optional[int] = None, tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    """R^dof; `dof` defaults to the tensor's last dimension."""
    if dof is None:
        if tensor is None:
            raise ValueError("Vector needs dof or tensor")
        dof = int(tensor.shape[-1]) if hasattr(tensor, "shape") else int(np.asarray(tensor).shape[-1])
    return ManifoldVariable(euclidean(dof), tensor, name)


def Point2(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return Vector(2, tensor, name)


def Point3(tensor=None, name: Optional[str] = None) -> ManifoldVariable:
    return Vector(3, tensor, name)


def as_variable(value, name: Optional[str] = None) -> Variable:
    """Wrap raw data as an aux Variable. Python scalars become float64 numpy
    0-d arrays; build_aux casts floating aux to the objective dtype."""
    if isinstance(value, Variable):
        return value
    if not isinstance(value, (np.ndarray, torch.Tensor)):
        value = np.asarray(value)
    return Variable(tensor=value, name=name)
