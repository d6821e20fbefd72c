"""Per-level factor and substitution: CUDA kernels and plain twins (JAX counterpart: theseus_tpu/sparse/pallas_factorize.py).

Three entry points, each launching its kernel on a CUDA tensor and running
its plain twin on a CPU tensor:

- `level_factor(col_a, ks, kj)` -> newcol (`csrc/level_factor.cu`)
- `level_fwd_subst(ljk, yk, b, ldiag)` -> y (`csrc/level_subst.cu`)
- `level_bwd_subst(lcol, xr, y)` -> x (`csrc/level_subst.cu`)

All operands are AoS with the batch before the block: (C, rows, B, d, d)
and (C, rows, B, d). The gathers that build them and the scatters of the
results stay in sparse/cholesky.py. The twins follow cholesky.py's
`_factorize_levels` / `_solve_levels` arithmetic through the unrolled
ops/batched_linalg routines.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..config import check_no_grad, use_kernel
from ..ops.batched_linalg import (
    SMALL_DIM_MAX,
    chol_small,
    rt_solve_lower,
    solve_lower_vec,
    solve_upper_vec,
)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------
def level_factor_plain(col_a, ks, kj):
    """col_a (C, rl, B, d, d), ks (C, ul, rl, B, d, d), kj (C, ul, B, d, d)
    -> newcol (C, rl, B, d, d): [chol(sym(C_0)), C_r L^{-T}]."""
    upd = torch.einsum("curbik,cubjk->crbij", ks, kj)
    c = col_a - upd
    dblk = 0.5 * (c[:, 0] + c[:, 0].transpose(-1, -2))
    ld = chol_small(dblk)
    rest = rt_solve_lower(ld[:, None], c[:, 1:])
    return torch.cat([ld[:, None], rest], dim=1)


def level_fwd_subst_plain(ljk, yk, b, ldiag):
    """ljk (C, ul, B, d, d), yk (C, ul, B, d), b (C, B, d), ldiag (C, B, d, d)
    -> y (C, B, d) with y = L_jj^{-1} (b - sum_u L_jk y_k)."""
    acc = b - torch.einsum("cubij,cubj->cbi", ljk, yk)
    return solve_lower_vec(ldiag, acc)


def level_bwd_subst_plain(lcol, xr, y):
    """lcol (C, rl, B, d, d), xr (C, rl, B, d), y (C, B, d) -> x (C, B, d)
    with x = L_jj^{-T} (y - sum_{r>=1} L_rj^T x_r); row 0 is ignored."""
    acc = y - torch.einsum("crbij,crbi->cbj", lcol[:, 1:], xr[:, 1:])
    return solve_upper_vec(lcol[:, 0].transpose(-1, -2), acc)


# ---------------------------------------------------------------------------
# dispatching wrappers
# ---------------------------------------------------------------------------
def _prepare(name, tensors, d):
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands must share device and dtype")
    if d > SMALL_DIM_MAX:
        raise ValueError(f"{name}: the CUDA kernel takes blocks of d <= {SMALL_DIM_MAX}, got {d}")
    fn = getattr(_cuda.lib(), f"th_{name}_{_cuda.suffix(dt)}")
    return fn, [t.contiguous() for t in tensors]


def level_factor(col_a, ks, kj):
    check_no_grad(col_a, ks, kj)
    if not use_kernel(col_a):
        return level_factor_plain(col_a, ks, kj)
    C, rl, B, d, _ = col_a.shape
    ul = ks.shape[1]
    if ks.shape != (C, ul, rl, B, d, d) or kj.shape != (C, ul, B, d, d):
        raise ValueError(f"level_factor: shapes {col_a.shape}, {ks.shape}, {kj.shape} do not agree")
    fn, (col_a, ks, kj) = _prepare("level_factor", [col_a, ks, kj], d)
    out = torch.empty_like(col_a)
    with torch.cuda.device(col_a.device):
        rc = fn(col_a.data_ptr(), ks.data_ptr(), kj.data_ptr(), C, rl, ul, B, d,
                out.data_ptr(), _cuda.stream_of(col_a))
    _cuda.check(rc, "level_factor")
    _cuda.launches["level_factor"] += 1
    return out


def level_fwd_subst(ljk, yk, b, ldiag):
    check_no_grad(ljk, yk, b, ldiag)
    if not use_kernel(ljk):
        return level_fwd_subst_plain(ljk, yk, b, ldiag)
    C, ul, B, d, _ = ljk.shape
    if yk.shape != (C, ul, B, d) or b.shape != (C, B, d) or ldiag.shape != (C, B, d, d):
        raise ValueError(f"level_fwd_subst: shapes {ljk.shape}, {yk.shape}, {b.shape}, {ldiag.shape} do not agree")
    fn, (ljk, yk, b, ldiag) = _prepare("level_fwd_subst", [ljk, yk, b, ldiag], d)
    y = torch.empty_like(b)
    with torch.cuda.device(ljk.device):
        rc = fn(ljk.data_ptr(), yk.data_ptr(), b.data_ptr(), ldiag.data_ptr(), C, ul, B, d,
                y.data_ptr(), _cuda.stream_of(ljk))
    _cuda.check(rc, "level_fwd_subst")
    _cuda.launches["level_fwd_subst"] += 1
    return y


def level_bwd_subst(lcol, xr, y):
    check_no_grad(lcol, xr, y)
    if not use_kernel(lcol):
        return level_bwd_subst_plain(lcol, xr, y)
    C, rl, B, d, _ = lcol.shape
    if xr.shape != (C, rl, B, d) or y.shape != (C, B, d):
        raise ValueError(f"level_bwd_subst: shapes {lcol.shape}, {xr.shape}, {y.shape} do not agree")
    fn, (lcol, xr, y) = _prepare("level_bwd_subst", [lcol, xr, y], d)
    x = torch.empty_like(y)
    with torch.cuda.device(lcol.device):
        rc = fn(lcol.data_ptr(), xr.data_ptr(), y.data_ptr(), C, rl, B, d,
                x.data_ptr(), _cuda.stream_of(lcol))
    _cuda.check(rc, "level_bwd_subst")
    _cuda.launches["level_bwd_subst"] += 1
    return x
