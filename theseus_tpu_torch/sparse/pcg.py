"""Block-Jacobi preconditioned conjugate gradients on the block AtA (JAX counterpart: theseus_tpu/sparse/pcg.py).

An iterative alternative to the direct block Cholesky: CG needs only block
matvecs (one gather, a batched einsum and an `index_add_` for each
triangle), whatever the factor's fill. The iteration count is fixed and
convergence is a per-batch-element mask on the device, as in the JAX
package's `lax.scan`: a Python `break` would read the residual back to the
host every CG step. The threshold `(tol |b|)^2` is below float32's
resolution at the default tol, so in float32 every iteration runs.

The block-Jacobi preconditioner factors each diagonal block once by
`chol_small`; its inverse factor is formed once by the same unrolled
`solve_lower_vec`, then applied by two batched products an iteration (the
JAX package runs the two triangular solves every iteration: the same
arithmetic up to rounding, and two launches instead of ~4 d^2).

`pcg_block_solve` is differentiable (a `torch.autograd.Function`, the JAX
package's custom VJP): its backward runs a second PCG on the cotangent and
forms the AtA slots' cotangent from the two solutions.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.batched_linalg import chol_small, solve_lower_vec


class PCGSchedule:
    """Static tables for the block matvec (from a BlockPattern), as numpy
    arrays; `on(device)` returns them as long tensors, built once."""

    def __init__(self, pattern):
        self.pattern = pattern
        items = sorted(pattern.pair_slot.items(), key=lambda kv: kv[1])
        self.ii = np.array([k[0] for k, _ in items])
        self.jj = np.array([k[1] for k, _ in items])
        self.slots = np.array([s for _, s in items])
        self.offdiag = self.ii != self.jj
        self.diag_slots = np.arange(1, pattern.n_vars + 1)
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    def on(self, device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._dev:
            as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
            off = self.offdiag
            self._dev[key] = {
                "ii": as_long(self.ii), "jj": as_long(self.jj), "slots": as_long(self.slots),
                "ii_off": as_long(self.ii[off]), "jj_off": as_long(self.jj[off]),
                "off": as_long(np.nonzero(off)[0]), "diag": as_long(self.diag_slots),
                "is_diag": torch.as_tensor(~off, device=device),
            }
        return self._dev[key]


def _matvec(t, blocks, blocks_off, x):
    """y = H x from the gathered blocks (S, B, d, d) and their off-diagonal
    subset; x, y (n, B, d)."""
    contrib = torch.einsum("sbij,sbj->sbi", blocks, x[t["jj"]])
    y = torch.zeros_like(x).index_add_(0, t["ii"], contrib)
    contrib_t = torch.einsum("sbji,sbj->sbi", blocks_off, x[t["ii_off"]])
    return y.index_add_(0, t["jj_off"], contrib_t)


def block_matvec(sched: PCGSchedule, ata, x):
    """y = H x with H the symmetric block matrix; x, y (n, B, d)."""
    t = sched.on(x.device)
    blocks = ata[t["slots"]]
    return _matvec(t, blocks, blocks[t["off"]], x)


def _jacobi_inverse_factor(sched: PCGSchedule, ata):
    """L^{-1} of each symmetrized diagonal block's Cholesky factor,
    (n, B, d, d)."""
    t = sched.on(ata.device)
    d = ata[t["diag"]]
    lfac = chol_small(0.5 * (d + d.transpose(-1, -2)))
    eye = torch.eye(lfac.shape[-1], dtype=lfac.dtype, device=lfac.device)
    cols = solve_lower_vec(lfac[..., None, :, :], eye)  # (n, B, j, d): L^{-1} e_j
    return cols.transpose(-1, -2)


def _jacobi_apply(linv, r):
    """(L L^T)^{-1} r = L^{-T} (L^{-1} r)."""
    w = torch.einsum("nbij,nbj->nbi", linv, r)
    return torch.einsum("nbji,nbj->nbi", linv, w)


def _sum(a):
    return torch.sum(a, dim=(0, 2))  # (n, B, d) -> (B,)


def _pcg(sched: PCGSchedule, ata, b, iters: int, tol: float):
    """Solve H x = b; b (n, B, d). Returns x."""
    t = sched.on(b.device)
    blocks = ata[t["slots"]]
    blocks_off = blocks[t["off"]]
    linv = _jacobi_inverse_factor(sched, ata)
    x = torch.zeros_like(b)
    r = b
    z = _jacobi_apply(linv, r)
    p = z
    rz = _sum(r * z)
    threshold = (tol * torch.sqrt(_sum(b * b))) ** 2
    one = torch.ones_like(rz)
    for _ in range(iters):
        hp = _matvec(t, blocks, blocks_off, p)
        php = _sum(p * hp)
        active = _sum(r * r) > threshold
        alpha = torch.where(active, rz / torch.where(php == 0, one, php), torch.zeros_like(rz))
        x = x + alpha[None, :, None] * p
        r = r - alpha[None, :, None] * hp
        z = _jacobi_apply(linv, r)
        rz_new = _sum(r * z)
        beta = torch.where(active, rz_new / torch.where(rz == 0, one, rz), torch.zeros_like(rz))
        p = z + beta[None, :, None] * p
        rz = rz_new
    return x


class _PCGSolve(torch.autograd.Function):
    """x = H^{-1} b by PCG. Backward: h = H^{-1} g by a second PCG;
    d_b = h; d_H(i, j) = -(h_i x_j^T + x_i h_j^T) for an off-diagonal
    slot, -h_i x_i^T for a diagonal one (the matvec reads the stored
    diagonal block as it is, not symmetrized); slot 0 (padding) gets 0."""

    @staticmethod
    def forward(ctx, sched, ata, b, iters, tol):
        x = _pcg(sched, ata, b, iters, tol)
        ctx.sched, ctx.iters, ctx.tol = sched, iters, tol
        ctx.save_for_backward(ata, x)
        return x

    @staticmethod
    def backward(ctx, g):
        ata, x = ctx.saved_tensors
        sched = ctx.sched
        t = sched.on(g.device)
        h = _pcg(sched, ata, g, ctx.iters, ctx.tol)
        d_ata = None
        if ctx.needs_input_grad[1]:
            hi, xj = h[t["ii"]], x[t["jj"]]
            xi, hj = x[t["ii"]], h[t["jj"]]
            grad_diag = -torch.einsum("sbi,sbj->sbij", hi, xj)
            grad_off = grad_diag - torch.einsum("sbi,sbj->sbij", xi, hj)
            grads = torch.where(t["is_diag"][:, None, None, None], grad_diag, grad_off)
            d_ata = torch.zeros_like(ata).index_copy_(0, t["slots"], grads)
        return None, d_ata, h, None, None


def pcg_block_solve(sched: PCGSchedule, ata, b, iters: int = 100, tol: float = 1e-10):
    """x (n, B, d) with H x = b: `iters` masked PCG iterations."""
    return _PCGSolve.apply(sched, ata, b, int(iters), float(tol))
