"""Gaussians on manifolds and their tangent-space projections (JAX counterpart: theseus_tpu/optim/gaussian.py).

The building blocks of Gaussian belief propagation's marginals. Covariance
transport follows the exp-map jacobian rule (Sola et al. 2018, eq. 55):
    lam_tp = J_exp^T lam J_exp  (local),  lam = J_exp^{-T} lam_tp J_exp^{-1}
Every function takes batched elements (..., *shape) and tangents (..., dof).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..lie import Group


@dataclasses.dataclass
class ManifoldGaussian:
    """mean: list of group elements; precision: (..., dof_total, dof_total)."""

    mean: List
    precision: torch.Tensor
    name: str = "gaussian"

    @property
    def dof(self) -> int:
        return self.precision.shape[-1]


def local_gaussian(group: Group, variable, gaussian: ManifoldGaussian, return_mean: bool = True):
    """A single-variable gaussian projected into the tangent plane at
    `variable`: (mean_tp, lam_tp), or (eta_tp, lam_tp) when not
    return_mean."""
    if len(gaussian.mean) != 1:
        raise ValueError("local_gaussian expects a single-variable gaussian.")
    mean_tp = group.local(variable, gaussian.mean[0])
    (jac,), _ = group.jexp(mean_tp)
    lam_tp = jac.transpose(-1, -2) @ gaussian.precision @ jac
    if return_mean:
        return mean_tp, lam_tp
    return (lam_tp @ mean_tp[..., None])[..., 0], lam_tp


def retract_gaussian(group: Group, variable, mean_tp, precision_tp) -> ManifoldGaussian:
    """A tangent-plane gaussian at `variable` mapped back to the manifold.
    The jacobian's inverse is `inv_ex` with NaN where it fails (no host
    sync on the card; `jnp.linalg.inv` gives non-finite values there too)."""
    mean = group.retract(variable, mean_tp)
    (jac,), _ = group.jexp(mean_tp)
    inv_jac, info = torch.linalg.inv_ex(jac)
    inv_jac = torch.where((info != 0)[..., None, None], torch.nan, inv_jac)
    precision = inv_jac.transpose(-1, -2) @ precision_tp @ inv_jac
    return ManifoldGaussian(mean=[mean], precision=precision)
