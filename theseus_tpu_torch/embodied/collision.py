"""Collision costs: the 2-D signed distance field lookup, the hinge collision cost and the effector-object contact constraint (JAX counterpart: theseus_tpu/embodied/collision.py).

The SDF is a bilinear interpolation of four clamped cell gathers, zero out
of bounds: differentiable everywhere except on cell boundaries, as in the
JAX package. Both costs are written for one instance and one batch element
and take autodiff jacobians: the compiled objective maps them with
torch.func.vmap over the instances (the map, shared by every instance, is
unmapped) and the batch, and differentiates them with jacfwd.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.cost_function import CostFunction, _as_batched_scalar
from ..core.variable import ManifoldVariable, as_variable
from ..lie import se2 as se2_ops


def sdf_signed_distance(sdf_data, origin, cell_size, point):
    """One point's bilinear SDF lookup. sdf_data (H, W) [row ~ y, col ~ x],
    origin (2,), cell_size (1,), point (2,). Returns (dist, out_of_bounds).
    The four cells are gathered from the flattened map (r W + c)."""
    rows, cols = sdf_data.shape[-2:]
    cs = cell_size[0] if cell_size.dim() else cell_size
    px, py = point[0], point[1]
    oob = (
        (px < origin[0])
        | (px > origin[0] + (cols - 1.0) * cs)
        | (py < origin[1])
        | (py > origin[1] + (rows - 1.0) * cs)
    )
    col = (px - origin[0]) / cs
    row = (py - origin[1]) / cs
    lr, lc = torch.floor(row), torch.floor(col)
    lri = torch.clamp(lr.to(torch.int64), 0, rows - 1)
    lci = torch.clamp(lc.to(torch.int64), 0, cols - 1)
    hri = torch.clamp(lri + 1, 0, rows - 1)
    hci = torch.clamp(lci + 1, 0, cols - 1)
    hrdiff, hcdiff = lr + 1.0 - row, lc + 1.0 - col
    lrdiff, lcdiff = row - lr, col - lc
    flat = sdf_data.reshape(-1)
    # one index_select of the four cells: a 0-d index tensor would be read
    # back as a Python int inside jacfwd's own vmap
    cells = torch.index_select(flat, 0, torch.stack([lri * cols + lci, hri * cols + lci,
                                                     lri * cols + hci, hri * cols + hci]))
    dist = (
        hrdiff * hcdiff * cells[0]
        + lrdiff * hcdiff * cells[1]
        + hrdiff * lcdiff * cells[2]
        + lrdiff * lcdiff * cells[3]
    )
    return torch.where(oob, torch.zeros_like(dist), dist), oob


def occupancy_to_sdf(occupancy_map: np.ndarray, cell_size: float, threshold: float = 0.75) -> np.ndarray:
    """Occupancy grid -> SDF by Euclidean distance transforms (scipy, on
    the host): the distance to the nearest occupied cell outside obstacles,
    minus the distance to the nearest free cell inside."""
    from scipy import ndimage

    occ = np.asarray(occupancy_map) >= threshold
    if occ.all():
        return -np.ones_like(occupancy_map, dtype=np.float64) * cell_size
    if (~occ).all():
        return np.ones_like(occupancy_map, dtype=np.float64) * cell_size
    dist_out = ndimage.distance_transform_edt(~occ) * cell_size
    dist_in = ndimage.distance_transform_edt(occ) * cell_size
    return dist_out - dist_in


class Collision2D(CostFunction):
    """Hinge on the SDF lookup: err = max(cost_eps - dist, 0) (torch.maximum:
    half the gradient at the hinge, as jnp.maximum). The pose is Point2 or
    SE2."""

    has_analytic_jacobians = False

    def __init__(
        self,
        pose: ManifoldVariable,
        sdf_origin,
        sdf_data,
        sdf_cell_size,
        cost_eps,
        cost_weight=None,
        name: Optional[str] = None,
    ):
        self.is_se2 = pose.group.name == "SE2"
        if not self.is_se2 and pose.group.dof != 2:
            raise ValueError("Collision2D only accepts Point2 or SE2 poses.")
        aux = [
            as_variable(sdf_origin),
            as_variable(sdf_data),
            _as_batched_scalar(sdf_cell_size),
            _as_batched_scalar(cost_eps),
        ]
        super().__init__([pose], aux, cost_weight, name)

    def dim(self):
        return 1

    def error_impl(self, optim, aux):
        (pose,) = optim
        origin, sdf_data, cell_size, cost_eps = aux
        xy = pose[:2] if self.is_se2 else pose
        dist, _ = sdf_signed_distance(sdf_data, origin, cell_size, xy)
        hinge = cost_eps - dist
        return torch.maximum(hinge, torch.zeros_like(hinge))


class EffectorObjectContactPlanar(CostFunction):
    """|dist(obj^{-1} eff_xy) - eff_radius|: the effector touches the
    object's surface. Both poses are SE2. At contact the derivative of |.|
    is +1, as jnp.abs's."""

    has_analytic_jacobians = False

    def __init__(
        self,
        obj: ManifoldVariable,
        eff: ManifoldVariable,
        sdf_origin,
        sdf_data,
        sdf_cell_size,
        eff_radius,
        cost_weight=None,
        name: Optional[str] = None,
    ):
        aux = [
            as_variable(sdf_origin),
            as_variable(sdf_data),
            _as_batched_scalar(sdf_cell_size),
            _as_batched_scalar(eff_radius),
        ]
        super().__init__([obj, eff], aux, cost_weight, name)

    def dim(self):
        return 1

    def error_impl(self, optim, aux):
        obj, eff = optim
        origin, sdf_data, cell_size, eff_radius = aux
        eff__obj = se2_ops.untransform(obj, eff[:2])
        dist, _ = sdf_signed_distance(sdf_data, origin, cell_size, eff__obj)
        gap = dist - eff_radius
        # |gap| with jnp.abs's derivative: +1 at gap = 0 (torch.abs gives 0)
        return torch.where(gap >= 0, gap, -gap)
