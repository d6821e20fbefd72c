"""Group namespaces bundling the functional Lie ops (JAX counterpart: theseus_tpu/lie/group.py).

Only SE3 is registered: it is the one group the PGO slice uses. The derived
ops follow the JAX package: retract = compose(g, exp(delta)),
local = log(a^{-1} b), between = a^{-1} b.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from . import se3


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

    def retract(self, g, delta):
        """g * exp(delta)."""
        return self.mod.compose(g, self.mod.exp(delta))

    def local(self, a, b):
        """log(a^{-1} b)."""
        return self.mod.log(self.mod.compose(self.mod.inverse(a), b))

    def between(self, a, b):
        return self.mod.compose(self.mod.inverse(a), b)

    def identity(self, *batch, dtype, device):
        return self.mod.identity(*batch, dtype=dtype, device=device)


SE3 = Group(name="SE3", dof=se3.DOF, shape=se3.SHAPE, mod=se3)


def by_name(name: str) -> Group:
    table = {"SE3": SE3}
    if name not in table:
        raise NotImplementedError(
            f"group {name} is not ported yet (ROADMAP.md, queue 1, slice 3)"
        )
    return table[name]
