"""Bulk construction: variable families and cost families (JAX counterpart: theseus_tpu/core/family.py).

A large homogeneous problem (bundle adjustment: 2*10^5 Reprojection costs)
built one Python object per cost costs O(N) objects and O(N) small host
arrays stacked at every `build_aux`. The stacked representation is the
user-facing primitive instead:

- `VariableFamily`: N same-group variables backed by one (N, B, *shape)
  array. Members are lightweight views (`fam[i]`) usable by ordinary cost
  functions (a gauge prior on camera 0).
- `CostFamily`: N structurally identical costs given by one template cost,
  per-slot member index arrays and pre-stacked (N, B|1, ...) aux arrays.
  The compiler turns it into one evaluation bucket, the same bucket schema
  grouping makes of N costs added one by one. A robust template (a
  RobustCostFunction around the template cost) follows the same rule: its
  (1, 1) log radius is one shared aux slot, a per-cost (N, 1, 1) radius a
  stacked one.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..lie import Group
from ..lie import group as _groupmod
from .cost_function import CostFunction
from .variable import ManifoldVariable, _auto_name


class VariableFamily:
    """N same-group optimization variables backed by one stacked array.

    `tensor` (optional default) has shape (N, B, *group.shape); per-call
    values come under `name` in the values dict with the same layout. Member
    views `fam[i]` are ManifoldVariables named `name[i]` that reference this
    family (attributes `family`, `family_index`)."""

    def __init__(self, group: Group, count: int, name: Optional[str] = None, tensor=None):
        if count < 1:
            raise ValueError("VariableFamily needs count >= 1")
        self.group = group
        self.count = int(count)
        self.name = name or _auto_name(f"{group.name}Family")
        if tensor is not None and not isinstance(tensor, (np.ndarray, torch.Tensor)):
            tensor = np.asarray(tensor)
        if tensor is not None:
            expect = (self.count,) + tuple(group.shape)
            got = tuple(tensor.shape[:1]) + tuple(tensor.shape[2:])
            if got != expect:
                raise ValueError(
                    f"family tensor must be (count, B, *shape)={expect}, got {tuple(tensor.shape)}"
                )
        self.tensor = tensor
        self._views: Dict[int, ManifoldVariable] = {}

    @property
    def dof(self) -> int:
        return self.group.dof

    def member_name(self, i: int) -> str:
        return f"{self.name}[{i}]"

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, i: int) -> ManifoldVariable:
        i = int(i)
        if not 0 <= i < self.count:
            raise IndexError(f"{self.name}[{i}] out of range (count={self.count})")
        v = self._views.get(i)
        if v is None:
            v = ManifoldVariable(self.group, None, name=self.member_name(i))
            v.family = self
            v.family_index = i
            self._views[i] = v
        return v

    def default(self, dtype: torch.dtype, device):
        if self.tensor is not None:
            return self.tensor
        ident = self.group.identity(1, dtype=dtype, device=device)
        return ident[None].expand((self.count,) + tuple(ident.shape))

    def __repr__(self):
        return f"VariableFamily({self.group.name}, count={self.count}, name={self.name})"


def SE3Family(count, name=None, tensor=None) -> VariableFamily:
    return VariableFamily(_groupmod.SE3, count, name, tensor)


def SO3Family(count, name=None, tensor=None) -> VariableFamily:
    return VariableFamily(_groupmod.SO3, count, name, tensor)


def SE2Family(count, name=None, tensor=None) -> VariableFamily:
    return VariableFamily(_groupmod.SE2, count, name, tensor)


def SO2Family(count, name=None, tensor=None) -> VariableFamily:
    return VariableFamily(_groupmod.SO2, count, name, tensor)


def VectorFamily(dof, count, name=None, tensor=None) -> VariableFamily:
    return VariableFamily(_groupmod.euclidean(dof), count, name, tensor)


def Point3Family(count, name=None, tensor=None) -> VariableFamily:
    return VectorFamily(3, count, name, tensor)


def Point2Family(count, name=None, tensor=None) -> VariableFamily:
    return VectorFamily(2, count, name, tensor)


MemberRef = Union[Tuple[VariableFamily, np.ndarray], ManifoldVariable]


class CostFamily:
    """N structurally identical costs as one bulk object.

    - `template`: a CostFunction over family member views (typically
      `fam[0]`) whose aux-variable tensors hold the STACKED per-instance
      arrays, shape (N, B|1, *aux_shape). Aux tensors whose leading dim is
      not N (or whose names are in `shared_aux`) are shared by all
      instances, shape (B|1, *aux_shape).
    - `members`: one entry per optim slot of the template, either
      `(family, idx)` with idx an (N,) int array of member indices, or a
      plain ManifoldVariable shared by every instance.
    - The template's weight follows the same stacked-or-shared rule.

    Equivalent to adding the N per-instance costs one by one."""

    def __init__(
        self,
        template: CostFunction,
        members: Sequence[MemberRef],
        name: Optional[str] = None,
        shared_aux: Sequence[str] = (),
    ):
        if len(members) != len(template.optim_vars):
            raise ValueError(
                f"CostFamily needs one member ref per template optim slot "
                f"({len(template.optim_vars)}), got {len(members)}"
            )
        count = None
        norm = []
        for si, m in enumerate(members):
            if isinstance(m, ManifoldVariable):
                norm.append(m)
                continue
            fam, idx = m
            idx = np.asarray(idx, dtype=np.int64)
            if idx.ndim != 1:
                raise ValueError("member index arrays must be 1-D")
            if idx.size and (idx.min() < 0 or idx.max() >= fam.count):
                raise ValueError(f"slot {si}: index out of range for family {fam.name}")
            if count is None:
                count = int(idx.shape[0])
            elif count != idx.shape[0]:
                raise ValueError("member index arrays disagree on count")
            if fam.group != template.optim_vars[si].group:
                raise ValueError(
                    f"slot {si}: family group {fam.group.name} != template "
                    f"group {template.optim_vars[si].group.name}"
                )
            norm.append((fam, idx))
        if count is None:
            raise ValueError("CostFamily needs at least one (family, idx) member slot")
        self.template = template
        self.members: Tuple[MemberRef, ...] = tuple(norm)
        self.count = count
        self.name = name or f"{type(template).__name__}Family__{id(self)}"
        self.shared_aux = frozenset(shared_aux)

    def dim(self) -> int:
        return self.template.dim()

    def total_dim(self) -> int:
        return self.count * self.template.dim()

    def aux_is_stacked(self, var) -> bool:
        t = var.tensor
        return (
            t is not None
            and getattr(t, "ndim", 0) >= 1
            and t.shape[0] == self.count
            and var.name not in self.shared_aux
        )

    def __repr__(self):
        return f"CostFamily({type(self.template).__name__}, count={self.count}, name={self.name})"
