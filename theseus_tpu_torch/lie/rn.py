"""R^n as a trivial Lie group (JAX counterpart: theseus_tpu/lie/rn.py).

Element layout (..., d). exp and log are the identity, compose is addition,
so retract is g + delta and local is b - a. Because the dof varies, the ops
take the vector itself; `group.euclidean(dof)` builds the namespace for one
dof.
"""

from __future__ import annotations

import torch

from .utils import draw


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    return torch.eye(d, dtype=x.dtype, device=x.device).expand(x.shape + (d,))


def exp(x):
    return x


def jexp(x):
    return [_eye_like(x)], x


def log(g):
    return g


def jlog(g):
    return [_eye_like(g)], g


def compose(g1, g2):
    return g1 + g2


def jcompose(g1, g2):
    ret = g1 + g2
    eye = _eye_like(ret)
    return [eye, eye], ret


def inverse(g):
    return -g


def jinverse(g):
    return [-_eye_like(g)], -g


def adjoint(g):
    return _eye_like(g)


def egrad_to_tangent(g, grad):
    """A Euclidean gradient is already the tangent one."""
    return grad


def identity(dof: int, *batch, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(batch) + (dof,), dtype=dtype, device=device)


def rand(dof: int, *batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform in [0, 1)^dof."""
    return draw(False, tuple(batch) + (dof,), generator, dtype, device)


def randn(dof: int, *batch, generator=None, dtype: torch.dtype, device) -> torch.Tensor:
    return draw(True, tuple(batch) + (dof,), generator, dtype, device)


def normalize(g):
    return g
