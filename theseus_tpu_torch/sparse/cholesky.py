"""Batched block-sparse Cholesky: level plan, factorization, solves (JAX counterpart: theseus_tpu/sparse/cholesky.py).

The level-scheduled plan only: every elimination-tree level is eliminated by
one gather, one `level_factor` launch and one scatter; both substitutions
sweep the levels with one `level_fwd_subst` / `level_bwd_subst` launch per
level. This is the structure of the JAX package's
`_factorize_levels_pallas` / `_solve_levels_pallas`, with the batch kept in
the AoS position (n, B, d, d).

Not ported yet (ROADMAP.md, queue 1): the dense trailing supernode, the
per-column scan plan for deep elimination trees, level runs, and the custom
backward of `sparse_block_solve`. A schedule that would need the first two
raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .assemble import BlockPattern
from .level_kernels import level_bwd_subst, level_factor, level_fwd_subst
from .refine import MatvecTables, block_matvec, hp_dtype, matvec_tables, refine, refine_active
from .structure import SymbolicFactor


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
        self._matvec_tables: Dict[str, MatvecTables] = {}
        self._device: Dict[str, tuple] = {}

    def matvec_tables(self, device) -> MatvecTables:
        """Gather tables of the iterative-refinement block SpMV, as tensors on
        `device` (built once per device)."""
        key = str(device)
        if key not in self._matvec_tables:
            t = matvec_tables(self.pattern.pair_slot, self.pattern.n_vars)
            self._matvec_tables[key] = MatvecTables(
                *(torch.as_tensor(a, device=device) for a in t)
            )
        return self._matvec_tables[key]

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


def factorize(sched: NumericSchedule, ata_flat: torch.Tensor) -> torch.Tensor:
    """ata_flat (n_slots, B, d, d) -> Lflat (nnz_l+1, B, d, d)."""
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


def solve_with_factor(sched: NumericSchedule, lflat: torch.Tensor, atb: torch.Tensor):
    """Solve H x = atb given L. atb (n, B, d) original var order -> x same."""
    perm, iperm, _ = sched.on(atb.device)
    y = forward_sweep(sched, lflat, atb[perm])
    return backward_sweep(sched, lflat, y)[iperm]


def _refine_with_factor(sched, lflat, ata_flat, b, x0):
    """config.REFINE_STEPS mixed-precision refinement sweeps reusing the
    factor (a no-op unless the high-precision tier is active)."""
    from .. import config

    if not refine_active(b.dtype):
        return x0
    tables = sched.matvec_tables(b.device)
    hp = hp_dtype(b.dtype)
    return refine(
        lambda r: solve_with_factor(sched, lflat, r),
        lambda xv: block_matvec(tables, ata_flat, xv, hp),
        b, x0, config.REFINE_STEPS,
    )


def sparse_block_solve(sched: NumericSchedule, ata_flat, atb):
    """x = H^{-1} atb with H the assembled block matrix (forward only)."""
    lflat = factorize(sched, ata_flat)
    x = solve_with_factor(sched, lflat, atb)
    return _refine_with_factor(sched, lflat, ata_flat, atb, x)
