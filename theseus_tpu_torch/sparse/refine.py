"""Mixed-precision iterative refinement of the normal-equation solves (JAX counterpart: theseus_tpu/sparse/refine.py).

    factor H once in the working dtype
    x_0 = L^-T L^-1 b
    repeat REFINE_STEPS times:
        r = b - H x                 (residual accumulated in float64)
        x = x + L^-T L^-1 r         (working-dtype substitution)

Active only with the high-precision tier on (config.HIGH_PRECISION_TIER)
and a working dtype below float64, the same condition under which the JAX
package refines (x64 enabled and an f32 solve). The refinement sweeps reuse
the factor and the substitution kernels.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import config


def hp_dtype(dtype: torch.dtype) -> torch.dtype:
    """The high-precision accumulation dtype of this configuration."""
    if dtype == torch.float64 or config.HIGH_PRECISION_TIER:
        return torch.float64
    return dtype


def refine_active(dtype: torch.dtype) -> bool:
    return config.REFINE_STEPS > 0 and hp_dtype(dtype) != dtype


class MatvecTables(NamedTuple):
    """Static gather tables for y = H x over canonical (i <= j) blocks."""

    ii: np.ndarray  # (S,) block-row of each stored slot
    jj: np.ndarray  # (S,) block-col
    slots: np.ndarray  # (S,) slot index into ata_flat
    off: np.ndarray  # (S,) bool, True where i != j
    # (n, maxdeg) rows into [0; yi (S); yj (S)] summed per output block row
    # (index 0 is a zero sentinel): a fixed-order sum, no atomics
    gather: np.ndarray


def matvec_tables(pair_slot, n: int) -> MatvecTables:
    items = sorted(pair_slot.items(), key=lambda kv: kv[1])
    ii = np.array([k[0] for k, _ in items], dtype=np.int64)
    jj = np.array([k[1] for k, _ in items], dtype=np.int64)
    slots = np.array([s for _, s in items], dtype=np.int64)
    off = ii != jj
    s_count = len(items)
    lists = [[] for _ in range(n)]
    for s in range(s_count):  # rows i get H_ij x_j
        lists[ii[s]].append(1 + s)
    for s in np.flatnonzero(off):  # rows j get H_ij^T x_i
        lists[jj[s]].append(1 + s_count + s)
    gather = np.zeros((n, max(1, max(len(l) for l in lists))), np.int64)
    for r, l in enumerate(lists):
        gather[r, : len(l)] = l
    return MatvecTables(ii=ii, jj=jj, slots=slots, off=off, gather=gather)


def block_matvec(tables: MatvecTables, ata_flat, x, out_dtype=None):
    """y = H x with H the symmetric matrix stored as canonical (i<=j) blocks.

    tables: MatvecTables of tensors on x's device; ata_flat (n_slots, B, d, d),
    x (n, B, d) -> y (n, B, d) in out_dtype. Diagonal blocks are read
    symmetrised, as the factorization reads them."""
    out_dtype = out_dtype or x.dtype
    blocks = ata_flat[tables.slots].to(out_dtype)  # (S, B, d, d)
    off = tables.off[:, None, None, None]
    blocks = torch.where(off, blocks, 0.5 * (blocks + blocks.transpose(-1, -2)))
    xh = x.to(out_dtype)
    yi = torch.einsum("sbij,sbj->sbi", blocks, xh[tables.jj])
    yj = torch.einsum("sbij,sbi->sbj", blocks, xh[tables.ii])
    rows = torch.cat([torch.zeros_like(yi[:1]), yi, yj], dim=0)
    return rows[tables.gather].sum(dim=1)


def solve_vjp(solve: Callable, tables: MatvecTables, ata_flat, x, g, need_d_ata: bool):
    """(d_ata, d_b) of x = H^{-1} b for the cotangent g, with h = solve(g) =
    H^{-1} g (H is symmetric, so d_b = h). d_ata, when asked for, is
    -(h_i x_j^T + x_i h_j^T) on each stored off-diagonal block and half of
    that on the diagonal blocks, which the solves read symmetrised; zero on
    unused slots. A batch element whose forward solution is not finite (a
    failed factorization, whose step the callers zero) gets zero cotangents:
    its NaN factor would otherwise turn the gradient of any parameter shared
    across the batch into NaN."""
    ok = torch.isfinite(x).all(dim=-1).all(dim=0)[None, :, None]  # (1, B, 1)
    h = torch.where(ok, solve(g), 0.0)
    if not need_d_ata:
        return None, h
    x = torch.where(ok, x, 0.0)
    grads = -(torch.einsum("nbi,nbj->nbij", h[tables.ii], x[tables.jj])
              + torch.einsum("nbi,nbj->nbij", x[tables.ii], h[tables.jj]))
    grads = torch.where(tables.off[:, None, None, None], grads, 0.5 * grads)
    d_ata = torch.zeros_like(ata_flat)
    d_ata[tables.slots] = grads
    return d_ata, h


def refine(inner_solve: Callable, matvec: Callable, b, x0, steps: int):
    """x ~= H^{-1} b by iterative refinement around a low-precision solver."""
    if steps <= 0:
        return x0
    hp = hp_dtype(b.dtype)
    xh = x0.to(hp)
    bh = b.to(hp)
    for _ in range(steps):
        r = bh - matvec(xh)
        dx = inner_solve(r.to(b.dtype))
        xh = xh + dx.to(hp)
    return xh.to(b.dtype)
