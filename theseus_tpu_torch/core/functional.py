"""The functional API on ManifoldVariables and the random constructors (JAX counterpart: theseus_tpu/core/functional.py).

compose, between, inverse, log_map, exp_map, adjoint, local and retract
dispatch on the variable's `group` and return new variables or tensors.
`rand_*` / `randn_*` take an explicit `torch.Generator` where the JAX
functions take a key (none: the device's default generator), and run on
`device`, the card when it is None.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import resolve_device
from ..lie import group as _groupmod
from ..lie.group import euclidean
from .variable import ManifoldVariable


def _g(v: ManifoldVariable):
    if not isinstance(v, ManifoldVariable):
        raise TypeError(f"expected a ManifoldVariable, got {type(v)}")
    return v.group


def _same(a: ManifoldVariable, b: ManifoldVariable, what: str):
    g = _g(a)
    if g != _g(b):
        raise ValueError(f"{what} needs matching groups, {g.name} vs {b.group.name}")
    return g


def compose(a: ManifoldVariable, b: ManifoldVariable, name=None) -> ManifoldVariable:
    g = _same(a, b, "compose")
    return ManifoldVariable(g, g.compose(a.tensor, b.tensor), name)


def between(a: ManifoldVariable, b: ManifoldVariable, name=None) -> ManifoldVariable:
    g = _same(a, b, "between")
    return ManifoldVariable(g, g.between(a.tensor, b.tensor), name)


def inverse(a: ManifoldVariable, name=None) -> ManifoldVariable:
    g = _g(a)
    return ManifoldVariable(g, g.inverse(a.tensor), name)


def log_map(a: ManifoldVariable) -> torch.Tensor:
    """Group element -> tangent coordinates (B, dof)."""
    return _g(a).log(a.tensor)


def exp_map(tangent, group, name=None) -> ManifoldVariable:
    """Tangent (B, dof) -> element of `group` (a lie.Group, or a variable
    whose group is taken)."""
    if isinstance(group, ManifoldVariable):
        group = group.group
    return ManifoldVariable(group, group.exp(torch.as_tensor(tangent)), name)


def adjoint(a: ManifoldVariable) -> torch.Tensor:
    return _g(a).adjoint(a.tensor)


def local(a: ManifoldVariable, b: ManifoldVariable) -> torch.Tensor:
    """Tangent coordinates of b in the frame of a: log(a^{-1} b)."""
    return _same(a, b, "local").local(a.tensor, b.tensor)


def retract(a: ManifoldVariable, delta, name=None) -> ManifoldVariable:
    g = _g(a)
    return ManifoldVariable(g, g.retract(a.tensor, torch.as_tensor(delta)), name)


# -- random constructors ------------------------------------------------------
def _draw(group, normal, batch_size, generator, dtype, device, name) -> ManifoldVariable:
    fn = group.randn if normal else group.rand
    return ManifoldVariable(group, fn(batch_size, generator=generator, dtype=dtype, device=resolve_device(device)),
                            name)


def _rand_ctor(group):
    def rand(batch_size: int = 1, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, device=None, name: Optional[str] = None) -> ManifoldVariable:
        return _draw(group, False, batch_size, generator, dtype, device, name)

    def randn(batch_size: int = 1, generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32, device=None, name: Optional[str] = None) -> ManifoldVariable:
        return _draw(group, True, batch_size, generator, dtype, device, name)

    return rand, randn


rand_so2, randn_so2 = _rand_ctor(_groupmod.SO2)
rand_se2, randn_se2 = _rand_ctor(_groupmod.SE2)
rand_so3, randn_so3 = _rand_ctor(_groupmod.SO3)
rand_se3, randn_se3 = _rand_ctor(_groupmod.SE3)
rand_point2, randn_point2 = _rand_ctor(_groupmod.Point2)
rand_point3, randn_point3 = _rand_ctor(_groupmod.Point3)


def rand_vector(dof: int, batch_size: int = 1, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32, device=None, name: Optional[str] = None) -> ManifoldVariable:
    return _draw(euclidean(dof), False, batch_size, generator, dtype, device, name)


def randn_vector(dof: int, batch_size: int = 1, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, device=None, name: Optional[str] = None) -> ManifoldVariable:
    return _draw(euclidean(dof), True, batch_size, generator, dtype, device, name)
