"""Batched block-sparse Cholesky: level and per-column plans, factorization, solves, and the solve's backward (JAX counterpart: theseus_tpu/sparse/cholesky.py).

Two numeric plans over one factor layout, the AoS (nnz_l+1, B, d, d) with
slot 0 zero:

- the level plan (the default): every elimination-tree level is eliminated
  by one gather, one `level_factor` launch and one scatter, and both
  substitutions sweep the levels with one `level_fwd_subst` /
  `level_bwd_subst` launch per level (the JAX package's
  `_factorize_levels_pallas` / `_solve_levels_pallas`);
- the whole-sweep plan (`config.set_whole_sweep(True)`, the JAX package's
  `PALLAS_WHOLE`): one launch per factorization and per substitution sweep
  (sparse/whole.py). Its plain twin is the per-column left-looking plan
  `_factorize_scan` / `_fwd_scan` / `_bwd_scan` (JAX `_factorize_scan`,
  `_solve_scan`, `_bwd_scan`), built on the per-column tables
  `NumericSchedule.a_src ... upd_valid`.

`sparse_block_solve` is differentiable (the JAX package's custom VJP): the
backward reuses the forward's factor for one more solve and launches no
factorization.

Not ported yet (ROADMAP.md, queue 1): the dense trailing supernode and the
per-column scan plan as the route for schedules without etree levels; a
schedule that would need either raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import config
from ..ops.batched_linalg import chol_small, rt_solve_lower, solve_lower_vec, solve_upper_vec
from .assemble import BlockPattern
from .level_kernels import level_bwd_subst, level_factor, level_fwd_subst
from .refine import block_matvec, hp_dtype, refine, refine_active
from .structure import SymbolicFactor
from .whole import solve_whole, whole_factor


class NumericSchedule:
    """Static numpy index tables combining SymbolicFactor with BlockPattern,
    padded per level to the level's (umax_l, rmax_l)."""

    def __init__(self, sym: SymbolicFactor, pattern: BlockPattern):
        self.sym = sym
        self.pattern = pattern
        n = sym.n
        self.n_head = sym.tail_start if sym.tail_start >= 0 else n
        self.tail_k = n - self.n_head
        # The JAX package caps the level plan (<= 100 levels, <= max(8, n/4))
        # to bound XLA program size and falls back to a per-column scan past
        # the caps. Eager launches have no program size, so here the level
        # plan runs whenever levels exist; it eliminates the same columns in
        # the same dependency order.
        self.use_levels = bool(sym.levels)
        if self.tail_k:
            raise NotImplementedError(
                f"the dense trailing supernode ({self.tail_k} columns) is not ported yet "
                "(ROADMAP.md, queue 1); config.set_sparse_dense_tail(False) avoids it"
            )
        if not self.use_levels:
            raise NotImplementedError(
                "a schedule without etree levels needs the per-column scan plan, which is "
                "not ported yet (ROADMAP.md, queue 1)"
            )
        self.diag_slots = np.asarray([sym.block_of[(j, j)] for j in range(n)], dtype=np.int32)
        self.perm = np.asarray(sym.perm, dtype=np.int32)
        self.iperm = np.asarray(sym.iperm, dtype=np.int32)
        self.level_tables = [self._build_level_table(cols) for cols in sym.levels]
        self._rect = None
        self._device: Dict[str, tuple] = {}

    def _build_level_table(self, cols):
        """Per-level tables built directly from the symbolic lists, padded to
        level-local maxima (the JAX package's `_build_level_table`)."""
        sym, pattern = self.sym, self.pattern
        block_of = sym.block_of
        cols = np.asarray(cols, dtype=np.int32)
        C = len(cols)
        rmax_l = max(len(sym.col_rows[int(j)]) for j in cols)
        umax_l = max(1, max(len(sym.upd_lists[int(j)]) for j in cols))

        a_src = np.zeros((C, rmax_l), dtype=np.int32)
        a_tr = np.zeros((C, rmax_l), dtype=bool)
        valid = np.zeros((C, rmax_l), dtype=bool)
        col_slots = np.zeros((C, rmax_l), dtype=np.int32)
        row_ids = np.zeros((C, rmax_l), dtype=np.int32)
        row_valid = np.zeros((C, rmax_l), dtype=bool)
        upd_slots = np.zeros((C, umax_l, rmax_l), dtype=np.int32)
        jk_slots = np.zeros((C, umax_l), dtype=np.int32)
        upd_k = np.zeros((C, umax_l), dtype=np.int32)
        upd_valid = np.zeros((C, umax_l), dtype=bool)
        for idx, j in enumerate(cols):
            j = int(j)
            pj = int(sym.perm[j])
            rows = sym.col_rows[j]
            rpos = {int(r): t for t, r in enumerate(rows)}
            for t, r in enumerate(rows):
                r = int(r)
                pr = int(sym.perm[r])
                lo, hi = (pr, pj) if pr <= pj else (pj, pr)
                s = pattern.pair_slot.get((lo, hi), 0)
                a_src[idx, t] = s
                a_tr[idx, t] = pr > pj and s != 0
                valid[idx, t] = True
                col_slots[idx, t] = block_of[(r, j)]
                row_ids[idx, t] = r
                row_valid[idx, t] = True
            for u, k in enumerate(sym.upd_lists[j]):
                jk_slots[idx, u] = block_of[(j, k)]
                upd_k[idx, u] = k
                upd_valid[idx, u] = True
                for r in sym.col_rows[k]:
                    r = int(r)
                    if r in rpos:
                        upd_slots[idx, u, rpos[r]] = block_of[(r, k)]
        return {
            "cols": cols,
            "a_src": a_src,
            "a_tr": a_tr,
            "valid": valid,
            "col_slots": col_slots,
            "row_ids": row_ids,
            "row_valid": row_valid,
            "upd_slots": upd_slots,
            "jk_slots": jk_slots,
            "upd_k": upd_k,
            "upd_valid": upd_valid,
            "diag_slots": np.asarray(
                [sym.block_of[(int(j), int(j))] for j in cols], dtype=np.int32
            ),
        }

    # ---- global per-column rectangles (per-column plan + whole sweep) ----
    # Built lazily: the level plan never needs them. They are the level
    # table of all head columns in elimination order, under the JAX
    # package's names.
    def _build_rect(self):
        if self._rect is None:
            t = self._build_level_table(np.arange(self.n_head))
            names = {"row_ids": "col_row_ids", "jk_slots": "upd_jk_slots"}
            self._rect = {names.get(k, k): v for k, v in t.items() if k not in ("cols", "diag_slots")}
        return self._rect

    a_src = property(lambda self: self._build_rect()["a_src"])
    a_tr = property(lambda self: self._build_rect()["a_tr"])
    valid = property(lambda self: self._build_rect()["valid"])
    col_slots = property(lambda self: self._build_rect()["col_slots"])
    col_row_ids = property(lambda self: self._build_rect()["col_row_ids"])
    row_valid = property(lambda self: self._build_rect()["row_valid"])
    upd_slots = property(lambda self: self._build_rect()["upd_slots"])
    upd_jk_slots = property(lambda self: self._build_rect()["upd_jk_slots"])
    upd_k = property(lambda self: self._build_rect()["upd_k"])
    upd_valid = property(lambda self: self._build_rect()["upd_valid"])

    def rect_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The per-column tables as index tensors (bool tables as masks) on
        `device`, built once per device, with the backward sweep's `below`
        mask (valid rows under the diagonal)."""
        key = ("rect", str(device))
        if key not in self._device:
            r = self._build_rect()
            out = {
                k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool else torch.long, device=device)
                for k, v in r.items()
            }
            rmax = r["row_valid"].shape[1]
            out["below"] = torch.as_tensor(
                r["row_valid"] & (np.arange(rmax)[None, :] > 0), device=device
            )
            out["diag_slots"] = torch.as_tensor(self.diag_slots, dtype=torch.long, device=device)
            self._device[key] = out
        return self._device[key]

    def on(self, device: torch.device):
        """(perm, iperm, per-level tables) as index tensors on `device`,
        built once per device. Bool tables become masks; the backward
        sweep's `below` mask (valid rows under the diagonal) is added."""
        key = str(device)
        if key not in self._device:
            def conv(a):
                dt = torch.bool if a.dtype == bool else torch.long
                return torch.as_tensor(a, dtype=dt, device=device)

            levels: List[dict] = []
            for t in self.level_tables:
                lt = {k: conv(v) for k, v in t.items()}
                rl = t["row_valid"].shape[1]
                lt["below"] = conv(t["row_valid"] & (np.arange(rl)[None, :] > 0))
                levels.append(lt)
            self._device[key] = (conv(self.perm), conv(self.iperm), levels)
        return self._device[key]


# Per-level operands of the three level kernels. The gathers, the a_tr
# transpose and the masks are indexed torch ops around the kernels, as they
# were XLA ops around the Pallas kernels.
def factor_operands(t, ata_flat, lflat):
    """(col_a (C, rl, B, d, d), ks (C, ul, rl, B, d, d), kj (C, ul, B, d, d))."""
    col_a = ata_flat[t["a_src"]]
    col_a = torch.where(t["a_tr"][:, :, None, None, None], col_a.transpose(-1, -2), col_a)
    return col_a, lflat[t["upd_slots"]], lflat[t["jk_slots"]]


def fwd_operands(t, lflat, y, b_perm):
    """(ljk, yk with invalid updates zeroed, b, ldiag) of one forward level."""
    yk = torch.where(t["upd_valid"][:, :, None, None], y[t["upd_k"]], 0.0)
    return lflat[t["jk_slots"]], yk, b_perm[t["cols"]], lflat[t["diag_slots"]]


def bwd_operands(t, lflat, x, y):
    """(lcol, xr with row 0 and invalid rows zeroed, y) of one backward level."""
    xr = torch.where(t["below"][:, :, None, None], x[t["row_ids"]], 0.0)
    return lflat[t["col_slots"]], xr, y[t["cols"]]


def factorize_levels(sched: NumericSchedule, ata_flat: torch.Tensor) -> torch.Tensor:
    """Level plan: ata_flat (n_slots, B, d, d) -> Lflat (nnz_l+1, B, d, d)."""
    _, _, levels = sched.on(ata_flat.device)
    bsz, d = ata_flat.shape[1], ata_flat.shape[-1]
    lflat = torch.zeros(
        (sched.sym.nnz_l + 1, bsz, d, d), dtype=ata_flat.dtype, device=ata_flat.device
    )
    for t in levels:
        newcol = level_factor(*factor_operands(t, ata_flat, lflat))
        newcol = torch.where(t["valid"][:, :, None, None, None], newcol, 0.0)
        # invalid rows all write zeros into the slot-0 sentinel
        lflat[t["col_slots"]] = newcol
    return lflat


def forward_sweep(sched: NumericSchedule, lflat, b_perm):
    """L y = b_perm in elimination order, level by level."""
    _, _, levels = sched.on(b_perm.device)
    y = torch.zeros_like(b_perm)
    for t in levels:
        y[t["cols"]] = level_fwd_subst(*fwd_operands(t, lflat, y, b_perm))
    return y


def backward_sweep(sched: NumericSchedule, lflat, y):
    """L^T x = y in elimination order, levels in reverse."""
    _, _, levels = sched.on(y.device)
    x = torch.zeros_like(y)
    for t in reversed(levels):
        x[t["cols"]] = level_bwd_subst(*bwd_operands(t, lflat, x, y))
    return x


def solve_levels(sched: NumericSchedule, lflat: torch.Tensor, atb: torch.Tensor):
    """Level plan: solve H x = atb given L. atb (n, B, d) original var
    order -> x same."""
    perm, iperm, _ = sched.on(atb.device)
    y = forward_sweep(sched, lflat, atb[perm])
    return backward_sweep(sched, lflat, y)[iperm]


# ---------------------------------------------------------------------------
# per-column left-looking plan: the plain twin of the whole-sweep kernels
# ---------------------------------------------------------------------------
def _factorize_scan(sched: NumericSchedule, ata_flat: torch.Tensor) -> torch.Tensor:
    """One column at a time in elimination order: gather the column of AtA,
    subtract the left-looking updates, POTRF the symmetrised diagonal
    block, TRSM the rows below. -> Lflat (nnz_l+1, B, d, d), slot 0 zero."""
    t = sched.rect_on(ata_flat.device)
    bsz, d = ata_flat.shape[1], ata_flat.shape[-1]
    lflat = torch.zeros((sched.sym.nnz_l + 1, bsz, d, d), dtype=ata_flat.dtype, device=ata_flat.device)
    for j in range(sched.n_head):
        col_a = ata_flat[t["a_src"][j]]  # (rmax, B, d, d)
        col_a = torch.where(t["a_tr"][j][:, None, None, None], col_a.transpose(-1, -2), col_a)
        ks = lflat[t["upd_slots"][j]]  # (umax, rmax, B, d, d)
        kj = lflat[t["upd_jk_slots"][j]]  # (umax, B, d, d)
        c = col_a - torch.einsum("urbik,ubjk->rbij", ks, kj)
        ld = chol_small(0.5 * (c[0] + c[0].transpose(-1, -2)))
        newcol = torch.cat([ld[None], rt_solve_lower(ld, c[1:])], dim=0)
        # invalid rows write zeros into the slot-0 sentinel
        lflat[t["col_slots"][j]] = torch.where(t["valid"][j][:, None, None, None], newcol, 0.0)
    return lflat


def _fwd_scan(sched: NumericSchedule, lflat, b_perm):
    """L y = b_perm one column at a time (pull form over the update lists)."""
    t = sched.rect_on(b_perm.device)
    y = torch.zeros_like(b_perm)
    for j in range(sched.n_head):
        yk = torch.where(t["upd_valid"][j][:, None, None], y[t["upd_k"][j]], 0.0)
        acc = b_perm[j] - torch.einsum("ubij,ubj->bi", lflat[t["upd_jk_slots"][j]], yk)
        y[j] = solve_lower_vec(lflat[t["diag_slots"][j]], acc)
    return y


def _bwd_scan(sched: NumericSchedule, lflat, y):
    """L^T x = y in internal (permuted) order, columns in reverse."""
    t = sched.rect_on(y.device)
    x = torch.zeros_like(y)
    for j in reversed(range(sched.n_head)):
        lcol = lflat[t["col_slots"][j]]  # (rmax, B, d, d); row 0 is the diagonal
        xr = torch.where(t["below"][j][:, None, None], x[t["col_row_ids"][j]], 0.0)
        acc = y[j] - torch.einsum("rbij,rbi->bj", lcol, xr)
        x[j] = solve_upper_vec(lcol[0].transpose(-1, -2), acc)
    return x


def _solve_scan(sched: NumericSchedule, lflat, atb):
    """Per-column plan: H x = atb, original variable order in and out."""
    perm, iperm, _ = sched.on(atb.device)
    return _bwd_scan(sched, lflat, _fwd_scan(sched, lflat, atb[perm]))[iperm]


# ---------------------------------------------------------------------------
# plan selection, refinement and the differentiable solve
# ---------------------------------------------------------------------------
def _use_whole(sched: NumericSchedule) -> bool:
    """The whole-sweep plan: config.WHOLE_SWEEP on and no dense tail. The
    JAX gate's column minimum (a TPU v5e A/B) and its VMEM/SMEM budgets are
    TPU facts and have no counterpart here."""
    return config.WHOLE_SWEEP and sched.tail_k == 0 and sched.n_head > 0


def factorize(sched: NumericSchedule, ata_flat: torch.Tensor) -> torch.Tensor:
    """ata_flat (n_slots, B, d, d) -> Lflat (nnz_l+1, B, d, d), by the plan
    config selects; both plans give the same layout."""
    if _use_whole(sched):
        return whole_factor(sched, ata_flat)
    return factorize_levels(sched, ata_flat)


def solve_with_factor(sched: NumericSchedule, lflat: torch.Tensor, atb: torch.Tensor):
    """Solve H x = atb given L. atb (n, B, d) original var order -> x same."""
    if _use_whole(sched):
        return solve_whole(sched, lflat, atb)
    return solve_levels(sched, lflat, atb)


def _refine_with_factor(sched, lflat, ata_flat, b, x0):
    """config.REFINE_STEPS mixed-precision refinement sweeps reusing the
    factor (a no-op unless the high-precision tier is active)."""
    if not refine_active(b.dtype):
        return x0
    tables = sched.pattern.matvec_tables(b.device)
    hp = hp_dtype(b.dtype)
    return refine(
        lambda r: solve_with_factor(sched, lflat, r),
        lambda xv: block_matvec(tables, ata_flat, xv, hp),
        b, x0, config.REFINE_STEPS,
    )


class _SparseBlockSolve(torch.autograd.Function):
    """x = H^{-1} atb with factor reuse (JAX `_solve_fwd` / `_solve_bwd`).

    Backward: h = H^{-1} g with the saved factor (plus refinement), so
    d_atb = h; d_ata, only when asked for, is -(h_i x_j^T + x_i h_j^T) on
    each stored off-diagonal block and half of that on the diagonal blocks
    (read symmetrised in the forward)."""

    @staticmethod
    def forward(ctx, sched, ata_flat, atb):
        lflat = factorize(sched, ata_flat)
        x = solve_with_factor(sched, lflat, atb)
        x = _refine_with_factor(sched, lflat, ata_flat, atb, x)
        ctx.sched = sched
        ctx.save_for_backward(lflat, ata_flat, x)
        return x

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        lflat, ata_flat, x = ctx.saved_tensors
        h = solve_with_factor(sched, lflat, g)  # H is symmetric
        h = _refine_with_factor(sched, lflat, ata_flat, g, h)
        d_ata = None
        if ctx.needs_input_grad[1]:
            t = sched.pattern.matvec_tables(g.device)
            grads = -(
                torch.einsum("nbi,nbj->nbij", h[t.ii], x[t.jj])
                + torch.einsum("nbi,nbj->nbij", x[t.ii], h[t.jj])
            )
            grads = torch.where(t.off[:, None, None, None], grads, 0.5 * grads)
            d_ata = torch.zeros_like(ata_flat)
            d_ata[t.slots] = grads
        return None, d_ata, h


def sparse_block_solve(sched: NumericSchedule, ata_flat, atb):
    """x = H^{-1} atb with H the assembled block matrix; differentiable in
    both inputs."""
    if config.needs_grad(ata_flat, atb):
        return _SparseBlockSolve.apply(sched, ata_flat, atb)
    lflat = factorize(sched, ata_flat)
    x = solve_with_factor(sched, lflat, atb)
    return _refine_with_factor(sched, lflat, ata_flat, atb, x)
