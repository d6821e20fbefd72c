"""Group namespaces bundling the functional Lie ops (JAX counterpart: theseus_tpu/lie/group.py).

SE3 (the pose-graph and bundle-adjustment cameras) and the Euclidean groups
`Rn{dof}` (bundle-adjustment landmarks) are registered. The derived ops
follow the JAX package: retract = compose(g, exp(delta)),
local = log(a^{-1} b), between = a^{-1} b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from . import rn, se3


@dataclasses.dataclass(frozen=True)
class Group:
    """Namespace of functional ops for one manifold/group type."""

    name: str
    dof: int
    shape: Tuple[int, ...]  # trailing element shape, e.g. (3, 4) for SE3
    mod: Any = dataclasses.field(compare=False, repr=False)

    def exp(self, x):
        return self.mod.exp(x)

    def log(self, g):
        return self.mod.log(g)

    def jlog(self, g):
        return self.mod.jlog(g)

    def compose(self, a, b):
        return self.mod.compose(a, b)

    def inverse(self, g):
        return self.mod.inverse(g)

    def adjoint(self, g):
        return self.mod.adjoint(g)

    def egrad_to_tangent(self, g, grad):
        """Project a Euclidean gradient of an element onto its right tangent
        space: the module's own rule, else `left_project`."""
        if hasattr(self.mod, "egrad_to_tangent"):
            return self.mod.egrad_to_tangent(g, grad)
        return self.mod.left_project(g, grad)

    def retract(self, g, delta):
        """g * exp(delta)."""
        return self.mod.compose(g, self.mod.exp(delta))

    def local(self, a, b):
        """log(a^{-1} b)."""
        return self.mod.log(self.mod.compose(self.mod.inverse(a), b))

    def between(self, a, b):
        return self.mod.compose(self.mod.inverse(a), b)

    def identity(self, *batch, dtype, device):
        if self.mod is rn:
            return rn.identity(self.dof, *batch, dtype=dtype, device=device)
        return self.mod.identity(*batch, dtype=dtype, device=device)


SE3 = Group(name="SE3", dof=se3.DOF, shape=se3.SHAPE, mod=se3)

_EUCLIDEAN: Dict[int, Group] = {}


def euclidean(dof: int) -> Group:
    """R^dof as a trivial group, named `Rn{dof}`."""
    if dof not in _EUCLIDEAN:
        _EUCLIDEAN[dof] = Group(name=f"Rn{dof}", dof=dof, shape=(dof,), mod=rn)
    return _EUCLIDEAN[dof]


def by_name(name: str) -> Group:
    if name == "SE3":
        return SE3
    if name.startswith("Rn") and name[2:].isdigit():
        return euclidean(int(name[2:]))
    raise NotImplementedError(
        f"group {name} is not ported yet (ROADMAP.md, queue 1, slice 3)"
    )
