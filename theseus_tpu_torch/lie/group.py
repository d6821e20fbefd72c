"""Group namespaces bundling the functional Lie ops (JAX counterpart: theseus_tpu/lie/group.py).

SO2, SE2, SO3, SE3 and the Euclidean groups `Rn{dof}` (Point2 and Point3
among them) are registered. The derived ops follow the JAX package:
retract = compose(g, exp(delta)), local = log(a^{-1} b),
between = a^{-1} b, with the analytic jacobians of between and local.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import rn, se2, se3, so2, so3


@dataclasses.dataclass(frozen=True)
class Group:
    """Namespace of functional ops for one manifold/group type."""

    name: str
    dof: int
    shape: Tuple[int, ...]  # trailing element shape, e.g. (3, 4) for SE3
    mod: Any = dataclasses.field(compare=False, repr=False)

    # --- the module's own ops -------------------------------------------
    def exp(self, x):
        return self.mod.exp(x)

    def jexp(self, x):
        return self.mod.jexp(x)

    def log(self, g):
        return self.mod.log(g)

    def jlog(self, g):
        return self.mod.jlog(g)

    def compose(self, a, b):
        return self.mod.compose(a, b)

    def jcompose(self, a, b):
        return self.mod.jcompose(a, b)

    def inverse(self, g):
        return self.mod.inverse(g)

    def jinverse(self, g):
        return self.mod.jinverse(g)

    def adjoint(self, g):
        return self.mod.adjoint(g)

    def normalize(self, g):
        return self.mod.normalize(g)

    def hat(self, x):
        return self.mod.hat(x)

    def vee(self, m):
        return self.mod.vee(m)

    def lift(self, x):
        return self.mod.lift(x)

    def project(self, m):
        return self.mod.project(m)

    def left_act(self, g, m):
        return self.mod.left_act(g, m)

    def left_project(self, g, m):
        return self.mod.left_project(g, m)

    def to_matrix(self, g):
        return self.mod.to_matrix(g)

    # --- the point action: transform for SE*, rotate for SO* -------------
    def transform(self, g, p):
        return self.mod.transform(g, p) if hasattr(self.mod, "transform") else self.mod.rotate(g, p)

    def untransform(self, g, p):
        return self.mod.untransform(g, p) if hasattr(self.mod, "untransform") else self.mod.unrotate(g, p)

    def jtransform(self, g, p):
        return self.mod.jtransform(g, p) if hasattr(self.mod, "jtransform") else self.mod.jrotate(g, p)

    def juntransform(self, g, p):
        return self.mod.juntransform(g, p) if hasattr(self.mod, "juntransform") else self.mod.junrotate(g, p)

    def egrad_to_tangent(self, g, grad):
        """Project a Euclidean gradient of an element onto its right tangent
        space: the module's own rule, else `left_project`."""
        if hasattr(self.mod, "egrad_to_tangent"):
            return self.mod.egrad_to_tangent(g, grad)
        return self.mod.left_project(g, grad)

    # --- derived ops ----------------------------------------------------
    def retract(self, g, delta):
        """g * exp(delta)."""
        return self.mod.compose(g, self.mod.exp(delta))

    def local(self, a, b):
        """log(a^{-1} b)."""
        return self.mod.log(self.mod.compose(self.mod.inverse(a), b))

    def between(self, a, b):
        return self.mod.compose(self.mod.inverse(a), b)

    def _bshape(self, a, b):
        k = len(self.shape)
        return torch.broadcast_shapes(a.shape[: a.dim() - k], b.shape[: b.dim() - k]) + (self.dof, self.dof)

    def jbetween(self, a, b):
        """J_a = -Adj(b^{-1} a), J_b = I."""
        diff = self.between(a, b)
        shape = self._bshape(a, b)
        ja = -self.mod.adjoint(self.mod.inverse(diff))
        jb = torch.eye(self.dof, dtype=a.dtype, device=a.device).expand(shape)
        return [ja.expand(shape), jb], diff

    def jlocal(self, a, b):
        """J_a = -Adj(diff^{-1}) jlog, J_b = jlog (the two factors commute
        as power series in ad_xi)."""
        diff = self.between(a, b)
        (dlog,), ret = self.mod.jlog(diff)
        ja = -self.mod.adjoint(self.mod.inverse(diff)) @ dlog
        shape = self._bshape(a, b)
        return [ja.expand(shape), dlog.expand(shape)], ret

    # --- constructors -----------------------------------------------------
    def identity(self, *batch, dtype, device):
        if self.mod is rn:
            return rn.identity(self.dof, *batch, dtype=dtype, device=device)
        return self.mod.identity(*batch, dtype=dtype, device=device)

    def rand(self, *batch, generator=None, dtype, device):
        if self.mod is rn:
            return rn.rand(self.dof, *batch, generator=generator, dtype=dtype, device=device)
        return self.mod.rand(*batch, generator=generator, dtype=dtype, device=device)

    def randn(self, *batch, generator=None, dtype, device):
        if self.mod is rn:
            return rn.randn(self.dof, *batch, generator=generator, dtype=dtype, device=device)
        return self.mod.randn(*batch, generator=generator, dtype=dtype, device=device)


SO2 = Group(name="SO2", dof=so2.DOF, shape=so2.SHAPE, mod=so2)
SE2 = Group(name="SE2", dof=se2.DOF, shape=se2.SHAPE, mod=se2)
SO3 = Group(name="SO3", dof=so3.DOF, shape=so3.SHAPE, mod=so3)
SE3 = Group(name="SE3", dof=se3.DOF, shape=se3.SHAPE, mod=se3)

_EUCLIDEAN: Dict[int, Group] = {}


def euclidean(dof: int) -> Group:
    """R^dof as a trivial group, named `Rn{dof}`."""
    if dof not in _EUCLIDEAN:
        _EUCLIDEAN[dof] = Group(name=f"Rn{dof}", dof=dof, shape=(dof,), mod=rn)
    return _EUCLIDEAN[dof]


Point2 = euclidean(2)
Point3 = euclidean(3)


def by_name(name: str) -> Group:
    table = {"SO2": SO2, "SE2": SE2, "SO3": SO3, "SE3": SE3}
    if name in table:
        return table[name]
    if name.startswith("Rn"):
        return euclidean(int(name[2:]))
    raise KeyError(name)
