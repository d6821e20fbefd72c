"""Batched dense solvers for the normal equations (JAX counterpart: theseus_tpu/optim/linear.py).

Batched Cholesky or LU on AtA with ellipsoidal or additive damping, the
damping eps, mixed-precision refinement (sparse/refine.py) and the zeroing
of a singular batch element's step. The factorizations are the library's
(`torch.linalg.cholesky_ex`, `torch.linalg.solve_ex`), as the JAX package's
are XLA's.

The Cholesky solve is two `solve_triangular`s: on the card
`torch.cholesky_solve` reads a status back to the host (a sync every
solve), `cholesky_ex`, `solve_triangular` and `solve_ex` do not.
`jnp.linalg.cholesky` returns NaN for a matrix that is not positive
definite; `cholesky_ex` returns a partial factor and `info > 0`, and a solve
with it is finite garbage. So a batch element with `info != 0` gets a NaN
factor here (solve_ex: a NaN solution), exactly the JAX package's value,
and the finite check that follows flags it. Nothing reads `info` on the
host.
"""

from __future__ import annotations

import torch

from .. import config
from ..sparse.refine import refine, refine_active


def finite_or_zero(delta):
    """A batch element whose step came out non-finite (a non-positive pivot)
    gets a zero step and bad=True. Returns (delta (B, D), bad (B,))."""
    bad = torch.any(~torch.isfinite(delta), dim=-1)
    return torch.where(bad[..., None], torch.zeros_like(delta), delta), bad


def _per_batch(damping, like):
    """damping (a Python number, or a 0-d or (B,) tensor) as a (B,) tensor
    on like's device; a number is filled there, not copied from the host."""
    if isinstance(damping, torch.Tensor):
        d = damping.to(dtype=like.dtype)
        return d.expand(like.shape[:-1]) if d.dim() == 0 else d
    return torch.full(like.shape[:-1], float(damping), dtype=like.dtype, device=like.device)


def apply_damping(ata, damping, ellipsoidal: bool, eps: float):
    """AtA + diag(damping * diag(AtA) + eps) (ellipsoidal) or AtA + damping I
    (additive). ata (B, D, D); damping a scalar or (B,)."""
    diag = torch.diagonal(ata, dim1=-2, dim2=-1)
    d = _per_batch(damping, diag)
    add = d[..., None] * diag + eps if ellipsoidal else d[..., None].expand(diag.shape)
    return ata + torch.diag_embed(add)


def damping_diag(ata_diag, damping, ellipsoidal: bool):
    """The per-column damping actually applied (for the LM gain-ratio
    denominator)."""
    d = _per_batch(damping, ata_diag)
    if ellipsoidal:
        return d[..., None] * ata_diag
    return d[..., None].expand(ata_diag.shape)


def _nan_where(fail, x):
    """x with the batch elements where `fail` (B,) is set made NaN."""
    return torch.where(fail.reshape((-1,) + (1,) * (x.dim() - 1)), torch.nan, x)


def _finish(delta, check_singular: bool):
    if check_singular:
        return finite_or_zero(delta)
    return delta, torch.zeros(delta.shape[:-1], dtype=torch.bool, device=delta.device)


class DenseCholeskySolver:
    """Batched Cholesky on the damped normal equations."""

    supports_ellipsoidal = True

    def __init__(self, check_singular: bool = True, damping_eps: float = 1e-8):
        self.check_singular = check_singular
        self.damping_eps = damping_eps

    def solve(self, ata, atb, damping=0.0, ellipsoidal: bool = False):
        """ata (B, D, D), atb (B, D) -> (delta (B, D), bad (B,))."""
        damped = apply_damping(ata, damping, ellipsoidal, self.damping_eps)
        l, info = torch.linalg.cholesky_ex(damped)
        l = _nan_where(info != 0, l)

        def solve_l(r):
            # two triangular solves: torch.cholesky_solve reads a status
            # back to the host on the card, which would sync every solve
            y = torch.linalg.solve_triangular(l, r[..., None], upper=False)
            return torch.linalg.solve_triangular(l.mT, y, upper=True)[..., 0]

        delta = solve_l(atb)
        if refine_active(atb.dtype):
            damped_hp = damped.to(torch.float64)
            delta = refine(solve_l, lambda x: (damped_hp @ x[..., None])[..., 0],
                           atb, delta, config.REFINE_STEPS)
        return _finish(delta, self.check_singular)


class DenseLUSolver:
    """Batched LU solve of the damped normal equations."""

    supports_ellipsoidal = True

    def __init__(self, check_singular: bool = True, damping_eps: float = 1e-8):
        self.check_singular = check_singular
        self.damping_eps = damping_eps

    def solve(self, ata, atb, damping=0.0, ellipsoidal: bool = False):
        damped = apply_damping(ata, damping, ellipsoidal, self.damping_eps)
        delta, info = torch.linalg.solve_ex(damped, atb[..., None])
        return _finish(_nan_where(info != 0, delta[..., 0]), self.check_singular)
