"""LieArray: a typed tensor wrapper whose ops stay in the group (JAX counterpart: theseus_tpu/lie/lie_array.py).

The analog of torchlie's LieTensor: a tensor `data` and its `group`. The
closed ops (compose, inverse, between, retract) return LieArrays;
arithmetic raises unless it runs inside a `with as_euclidean():` block,
where it acts on the raw tensors; `.as_euclidean()` returns the raw
tensor. The free functions mirror the JAX package's.
"""

from __future__ import annotations

import threading

import torch

from .group import Group

_euclidean_ctx = threading.local()


def euclidean_enabled() -> bool:
    """True inside a `with as_euclidean():` block."""
    return getattr(_euclidean_ctx, "enabled", False)


class as_euclidean:
    """Inside the block, the arithmetic dunders of a LieArray act on `.data`
    and return plain tensors."""

    def __enter__(self):
        self._prev = euclidean_enabled()
        _euclidean_ctx.enabled = True
        return self

    def __exit__(self, *exc):
        _euclidean_ctx.enabled = self._prev
        return False


def _raw(x):
    return x.data if isinstance(x, LieArray) else x


class LieArray:
    def __init__(self, data, group: Group):
        self.data = data if isinstance(data, torch.Tensor) else torch.as_tensor(data)
        self.group = group

    # --- constructors ---------------------------------------------------
    @classmethod
    def identity(cls, group: Group, *batch, dtype: torch.dtype, device):
        return cls(group.identity(*batch, dtype=dtype, device=device), group)

    @classmethod
    def rand(cls, group: Group, *batch, generator=None, dtype: torch.dtype, device):
        return cls(group.rand(*batch, generator=generator, dtype=dtype, device=device), group)

    @classmethod
    def exp(cls, group: Group, tangent):
        return cls(group.exp(tangent), group)

    @classmethod
    def jexp(cls, group: Group, tangent):
        jacs, val = group.jexp(tangent)
        return jacs, cls(val, group)

    @classmethod
    def from_tensor(cls, data, group: Group) -> "LieArray":
        """Wrap an existing tensor without copying."""
        return cls(data, group)

    # --- closed ops -----------------------------------------------------
    def _check(self, other: "LieArray"):
        if not isinstance(other, LieArray) or other.group != self.group:
            other_name = getattr(getattr(other, "group", None), "name", type(other).__name__)
            raise ValueError(f"ltype mismatch: {self.group.name} vs {other_name}")

    def compose(self, other: "LieArray") -> "LieArray":
        self._check(other)
        return LieArray(self.group.compose(self.data, other.data), self.group)

    def inv(self) -> "LieArray":
        return LieArray(self.group.inverse(self.data), self.group)

    inverse = inv

    def log(self):
        return self.group.log(self.data)

    def adj(self):
        return self.group.adjoint(self.data)

    adjoint = adj

    def between(self, other: "LieArray") -> "LieArray":
        self._check(other)
        return LieArray(self.group.between(self.data, other.data), self.group)

    def local(self, other: "LieArray"):
        self._check(other)
        return self.group.local(self.data, other.data)

    def retract(self, delta) -> "LieArray":
        return LieArray(self.group.retract(self.data, delta), self.group)

    def normalize(self) -> "LieArray":
        return LieArray(self.group.normalize(self.data), self.group)

    def transform(self, point):
        return self.group.transform(self.data, point)

    def untransform(self, point):
        return self.group.untransform(self.data, point)

    def left_act(self, matrix):
        return self.group.left_act(self.data, matrix)

    def left_project(self, matrix):
        """A Euclidean gradient in matrix form -> right tangent."""
        return self.group.left_project(self.data, matrix)

    def hat(self, tangent):
        return self.group.hat(tangent)

    def vee(self, matrix):
        return self.group.vee(matrix)

    def to_matrix(self):
        return self.group.to_matrix(self.data)

    # --- jacobian variants -----------------------------------------------
    def jlog(self):
        return self.group.jlog(self.data)

    def jcompose(self, other: "LieArray"):
        self._check(other)
        jacs, val = self.group.jcompose(self.data, other.data)
        return jacs, LieArray(val, self.group)

    def jinverse(self):
        jacs, val = self.group.jinverse(self.data)
        return jacs, LieArray(val, self.group)

    jinv = jinverse

    def jinv(self):
        return self.jinverse()

    def jlocal(self, other: "LieArray"):
        self._check(other)
        return self.group.jlocal(self.data, other.data)

    def jtransform(self, point):
        """([d/dg, d/dp], transform)."""
        return self.group.jtransform(self.data, point)

    def juntransform(self, point):
        return self.group.juntransform(self.data, point)

    def jretract(self, delta):
        """([jexp(delta)], self * exp(delta))."""
        (jexp_d,), e = self.group.jexp(delta)
        return [jexp_d], LieArray(self.group.compose(self.data, e), self.group)

    # --- escape hatch / misc --------------------------------------------
    def as_euclidean(self):
        """The raw tensor."""
        return self.data

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def batch_shape(self):
        return self.data.shape[: self.data.dim() - len(self.group.shape)]

    def __getitem__(self, idx):
        return LieArray(self.data[idx], self.group)

    def __matmul__(self, other):
        """g @ h is compose; a raw matmul needs as_euclidean()."""
        if isinstance(other, LieArray):
            return self.compose(other)
        raise TypeError("Raw matmul on a LieArray is not allowed; use .as_euclidean() to get the tensor.")

    def __add__(self, other):
        if euclidean_enabled():
            return self.data + _raw(other)
        raise TypeError(
            "Addition is not a closed Lie op; use .retract(delta), .as_euclidean(), "
            "or a `with lie.as_euclidean():` block."
        )

    __radd__ = __add__

    def __sub__(self, other):
        if euclidean_enabled():
            return self.data - _raw(other)
        raise TypeError("Subtraction is not a closed Lie op; use .local(other) or a `with lie.as_euclidean():` block.")

    def __mul__(self, other):
        if euclidean_enabled():
            return self.data * _raw(other)
        raise TypeError(
            "`*` is not a closed Lie op; use `@` for composition or a `with lie.as_euclidean():` "
            "block for an elementwise product."
        )

    __rmul__ = __mul__

    def __repr__(self):
        return f"LieArray({self.group.name}, shape={tuple(self.data.shape)})"


# --- free functions -------------------------------------------------------
def as_lietensor(data, group: Group) -> LieArray:
    """Wrap data as a LieArray of `group`; a LieArray of that group passes
    through, one of another group raises."""
    if isinstance(data, LieArray):
        if data.group != group:
            raise ValueError(f"ltype mismatch: {data.group.name} vs {group.name}")
        return data
    return LieArray(data, group)


cast = as_lietensor
from_tensor = LieArray.from_tensor


def log(g: LieArray):
    return g.log()


def adj(g: LieArray):
    return g.adj()


def inv(g: LieArray) -> LieArray:
    return g.inv()


def compose(g1: LieArray, g2: LieArray) -> LieArray:
    return g1.compose(g2)


def between(g1: LieArray, g2: LieArray) -> LieArray:
    return g1.between(g2)


def transform(g: LieArray, point):
    return g.transform(point)


def untransform(g: LieArray, point):
    return g.untransform(point)


def left_act(g: LieArray, matrix):
    return g.left_act(matrix)


def left_project(g: LieArray, matrix):
    return g.left_project(matrix)


def retract(g: LieArray, delta) -> LieArray:
    return g.retract(delta)


def local(g1: LieArray, g2: LieArray):
    return g1.local(g2)


def normalize(g: LieArray) -> LieArray:
    return g.normalize()


def jlog(g: LieArray):
    return g.jlog()


def jinv(g: LieArray):
    return g.jinverse()


def jcompose(g1: LieArray, g2: LieArray):
    return g1.jcompose(g2)


def jtransform(g: LieArray, point):
    return g.jtransform(point)


def juntransform(g: LieArray, point):
    return g.juntransform(point)
