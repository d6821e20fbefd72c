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

Both plans cover the head columns. When the symbolic analysis amalgamates a
dense trailing supernode (`config.SPARSE_DENSE_TAIL`, any graph denser than
a chain), its K columns are factored after the head by one batched dense
POTRF (`torch.linalg.cholesky_ex`) and solved by two dense triangular
solves, as the JAX package's `_tail_*` functions do; the head's level
kernels write the head's L blocks whose rows lie in the tail, and the
backward sweep solves the tail before the head levels read its x. A clique
of 16 or more poses is the tail alone. The whole-sweep plan takes only
schedules without a tail (the JAX gate's rule); a tailed schedule runs the
level plan.

`sparse_block_solve` is differentiable (the JAX package's custom VJP): the
backward reuses the forward's factor for one more solve and launches no
factorization.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import config
from ..ops.batched_linalg import chol_small, rt_solve_lower, solve_lower_vec, solve_upper_vec
from ..tracing import span
from .assemble import BlockPattern
from .level_kernels import level_bwd_subst, level_factor, level_fwd_subst
from .refine import block_matvec, hp_dtype, refine, refine_active, solve_vjp
from .structure import SymbolicFactor
from .whole import solve_whole, whole_factor


class NumericSchedule:
    """Static numpy index tables combining SymbolicFactor with BlockPattern,
    padded per level to the level's (umax_l, rmax_l)."""

    def __init__(self, sym: SymbolicFactor, pattern: BlockPattern):
        self.sym = sym
        self.pattern = pattern
        n = sym.n
        # columns n_head..n-1: the dense trailing supernode (tail_k of them);
        # the level tables cover the head only (sym.levels excludes the tail)
        self.n_head = sym.tail_start if sym.tail_start >= 0 else n
        self.tail_k = n - self.n_head
        # The JAX package caps the level plan (<= 100 levels, <= max(8, n/4))
        # to bound XLA program size and falls back to a per-column scan past
        # the caps. Eager launches have no program size, so here the level
        # plan eliminates every head column; it eliminates the same columns
        # in the same dependency order.
        self.diag_slots = np.asarray([sym.block_of[(j, j)] for j in range(n)], dtype=np.int32)
        self.perm = np.asarray(sym.perm, dtype=np.int32)
        self.iperm = np.asarray(sym.iperm, dtype=np.int32)
        self.level_tables = [self._build_level_table(cols) for cols in sym.levels]
        self._build_tail_tables()
        self._rect = None
        self._device: Dict[str, tuple] = {}

    def _build_tail_tables(self):
        """Tables of the dense trailing supernode (the JAX package's
        `_build_tail_tables`), numpy. For tail column j (absolute
        cj = n_head + j):
        - tail_col_slots (K, K): factor slot of block (n_head + r, cj), 0
          where r < j (the strict upper part of the supernode);
        - tail_a_src / tail_a_tr (K, K): AtA slot and transpose flag;
        - tail_upd_* (K, ue, ...): the external left-looking updates, head
          columns k < n_head with L[cj, k] in the pattern (the updates inside
          the tail are the dense POTRF's own)."""
        if self.tail_k == 0:
            self.tail_ue = 0
            return
        sym, pattern = self.sym, self.pattern
        nh, K = self.n_head, self.tail_k
        block_of = sym.block_of
        ext = [[int(k) for k in sym.tail_ext_upd[j]] for j in range(K)]
        ue = max(1, max((len(e) for e in ext), default=1))
        self.tail_ue = ue

        col_slots = np.zeros((K, K), dtype=np.int32)
        a_src = np.zeros((K, K), dtype=np.int32)
        a_tr = np.zeros((K, K), dtype=bool)
        valid = np.zeros((K, K), dtype=bool)
        upd_slots = np.zeros((K, ue, K), dtype=np.int32)
        upd_jk = np.zeros((K, ue), dtype=np.int32)
        upd_k = np.zeros((K, ue), dtype=np.int32)
        upd_valid = np.zeros((K, ue), dtype=bool)
        for j in range(K):
            cj = nh + j
            pj = int(sym.perm[cj])
            for r in range(j, K):
                cr = nh + r
                col_slots[j, r] = block_of[(cr, cj)]
                valid[j, r] = True
                pr = int(sym.perm[cr])
                lo, hi = (pr, pj) if pr <= pj else (pj, pr)
                s = pattern.pair_slot.get((lo, hi), 0)
                a_src[j, r] = s
                a_tr[j, r] = pr > pj and s != 0
            for u, k in enumerate(ext[j]):
                upd_jk[j, u] = block_of[(cj, k)]
                upd_k[j, u] = k
                upd_valid[j, u] = True
                for r in range(j, K):
                    upd_slots[j, u, r] = block_of.get((nh + r, k), 0)

        self.tail_col_slots = col_slots
        self.tail_a_src = a_src
        self.tail_a_tr = a_tr
        self.tail_valid = valid
        self.tail_upd_slots = upd_slots
        self.tail_upd_jk = upd_jk
        self.tail_upd_k = upd_k
        self.tail_upd_valid = upd_valid

    def tail_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The tail tables as index tensors (bool tables as masks) on
        `device`, built once per device, with the supernode's strict-lower
        mask `strict` and the diagonal's indices `diag`, so that no solve
        copies an index from the host."""
        key = ("tail", str(device))
        if key not in self._device:
            K = self.tail_k
            host = {
                "col_slots": self.tail_col_slots, "a_src": self.tail_a_src, "a_tr": self.tail_a_tr,
                "valid": self.tail_valid, "upd_slots": self.tail_upd_slots, "upd_jk": self.tail_upd_jk,
                "upd_k": self.tail_upd_k, "upd_valid": self.tail_upd_valid,
                "strict": self.tail_valid & ~np.eye(K, dtype=bool), "diag": np.arange(K),
            }
            self._device[key] = {
                k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool else torch.long, device=device)
                for k, v in host.items()
            }
        return self._device[key]

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
    """Level plan: ata_flat (n_slots, B, d, d) -> Lflat (nnz_l+1, B, d, d):
    the head level by level, then the dense tail."""
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
    if sched.tail_k:
        _tail_dense_eliminate(sched, ata_flat, lflat)
    return lflat


def forward_sweep(sched: NumericSchedule, lflat, b_perm):
    """L y = b_perm in elimination order: the head level by level, then the
    dense tail."""
    _, _, levels = sched.on(b_perm.device)
    y = torch.zeros_like(b_perm)
    for t in levels:
        y[t["cols"]] = level_fwd_subst(*fwd_operands(t, lflat, y, b_perm))
    if sched.tail_k:
        y[sched.n_head:] = _tail_fwd_solve(sched, lflat, y, b_perm)
    return y


def backward_sweep(sched: NumericSchedule, lflat, y):
    """L^T x = y in elimination order: the dense tail first (the head's
    columns read its x), then the head levels in reverse."""
    _, _, levels = sched.on(y.device)
    x = torch.zeros_like(y)
    if sched.tail_k:
        x[sched.n_head:] = _tail_bwd_solve(sched, lflat, y)
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
# the dense trailing supernode (JAX sparse/cholesky.py `_tail_*`): plain
# torch on (B, K d, K d). The JAX package computes it with
# jnp.linalg.cholesky and jsl.solve_triangular outside any Pallas kernel.
# ---------------------------------------------------------------------------
def _tail_blocks_to_mat(c, valid, K, d):
    """c (K_col, K_row, B, d, d) masked lower blocks -> dense (B, K d, K d),
    lower triangular by blocks (the strict upper part zero)."""
    bsz = c.shape[2]
    c = torch.where(valid[:, :, None, None, None], c, 0.0)
    # (col j, row r, B, i, m) -> (B, r, i, j, m)
    return c.permute(2, 1, 3, 0, 4).reshape(bsz, K * d, K * d)


def _tail_mat_to_blocks(m, K, d):
    """dense (B, K d, K d) -> blocks (K_col, K_row, B, d, d)."""
    bsz = m.shape[0]
    # [b, r, i, j, m] -> [j, r, b, i, m]
    return m.reshape(bsz, K, d, K, d).permute(3, 1, 0, 2, 4)


def _tail_assemble_c(sched: NumericSchedule, ata_flat, lflat):
    """Per tail column, the blocks C = A - external updates, (K, K, B, d, d)."""
    t = sched.tail_on(ata_flat.device)
    col_a = ata_flat[t["a_src"]]
    col_a = torch.where(t["a_tr"][:, :, None, None, None], col_a.transpose(-1, -2), col_a)
    ks = lflat[t["upd_slots"]]  # (K, ue, K, B, d, d)
    kj = torch.where(t["upd_valid"][:, :, None, None, None], lflat[t["upd_jk"]], 0.0)
    return col_a - torch.einsum("curbik,cubjk->crbij", ks, kj)


def _tail_dense_eliminate(sched: NumericSchedule, ata_flat, lflat):
    """Factor the trailing supernode with one batched dense POTRF and write
    its blocks into lflat (in place), so that every substitution reads one
    layout. `cholesky_ex` reports a matrix that is not positive definite in
    `info` without a host sync; such a batch element's tail becomes NaN, as
    jnp.linalg.cholesky gives, so that LM rejects its step."""
    t = sched.tail_on(ata_flat.device)
    K, d = sched.tail_k, ata_flat.shape[-1]
    c = _tail_assemble_c(sched, ata_flat, lflat)
    # the symmetric matrix: strict lower, its transpose, the symmetrised diagonal
    lower = _tail_blocks_to_mat(c, t["strict"], K, d)
    cd = c[t["diag"], t["diag"]]  # (K, B, d, d)
    bsz = c.shape[2]
    dmat = torch.zeros((bsz, K, d, K, d), dtype=c.dtype, device=c.device)
    # advanced indices split by a slice land in front: values (K, B, d, d)
    dmat[:, t["diag"], :, t["diag"], :] = 0.5 * (cd + cd.transpose(-1, -2))
    dense = lower + lower.transpose(-1, -2) + dmat.reshape(bsz, K * d, K * d)
    ld, info = torch.linalg.cholesky_ex(dense)
    ld = torch.where((info != 0)[:, None, None], torch.nan, ld)
    blocks = torch.where(t["valid"][:, :, None, None, None], _tail_mat_to_blocks(ld, K, d), 0.0)
    # the strict upper entries all write zeros into the slot-0 sentinel
    lflat[t["col_slots"]] = blocks


def _tail_dense_l(sched: NumericSchedule, lflat):
    """The dense (B, K d, K d) tail factor from the factor's blocks."""
    t = sched.tail_on(lflat.device)
    return _tail_blocks_to_mat(lflat[t["col_slots"]], t["valid"], sched.tail_k, lflat.shape[-1])


def _tail_fwd_solve(sched: NumericSchedule, lflat, y, b_perm):
    """y of the tail columns (K, B, d): the dense lower solve of the
    supernode after subtracting the head's contributions (y holds the
    head's y)."""
    t = sched.tail_on(lflat.device)
    K, d, nh = sched.tail_k, b_perm.shape[-1], sched.n_head
    yk = torch.where(t["upd_valid"][:, :, None, None], y[t["upd_k"]], 0.0)
    acc = b_perm[nh:] - torch.einsum("kubij,kubj->kbi", lflat[t["upd_jk"]], yk)
    bsz = acc.shape[1]
    rhs = acc.movedim(0, 1).reshape(bsz, K * d, 1)
    yt = torch.linalg.solve_triangular(_tail_dense_l(sched, lflat), rhs, upper=False)
    return yt.reshape(bsz, K, d).movedim(1, 0)


def _tail_bwd_solve(sched: NumericSchedule, lflat, y):
    """x of the tail columns (K, B, d): the dense upper solve L^T x = y_tail
    (the tail is eliminated last, so no rows below it contribute)."""
    K, d, nh = sched.tail_k, y.shape[-1], sched.n_head
    bsz = y.shape[1]
    rhs = y[nh:].movedim(0, 1).reshape(bsz, K * d, 1)
    xt = torch.linalg.solve_triangular(_tail_dense_l(sched, lflat).transpose(-1, -2), rhs, upper=True)
    return xt.reshape(bsz, K, d).movedim(1, 0)


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
    """The whole-sweep plan: config.WHOLE_SWEEP on, no dense tail and a
    head, the JAX gate's rule (a tailed schedule runs the level plan). The
    JAX gate's column minimum (a TPU v5e A/B) and its VMEM/SMEM budgets are
    TPU facts and have no counterpart here."""
    return config.WHOLE_SWEEP and sched.tail_k == 0 and sched.n_head > 0


def factorize(sched: NumericSchedule, ata_flat: torch.Tensor) -> torch.Tensor:
    """ata_flat (n_slots, B, d, d) -> Lflat (nnz_l+1, B, d, d), by the plan
    config selects; both plans give the same layout."""
    with span("tt.factor"):
        if _use_whole(sched):
            return whole_factor(sched, ata_flat)
        return factorize_levels(sched, ata_flat)


def solve_with_factor(sched: NumericSchedule, lflat: torch.Tensor, atb: torch.Tensor):
    """Solve H x = atb given L. atb (n, B, d) original var order -> x same."""
    with span("tt.subst"):
        if _use_whole(sched):
            return solve_whole(sched, lflat, atb)
        return solve_levels(sched, lflat, atb)


def sample_with_factor(sched: NumericSchedule, lflat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y (n, B, d) iid N(0, 1) in elimination order -> x = P^T L^{-T} y,
    original variable order, whose covariance is H^{-1} (H = P^T L L^T P).
    The backward sweep only: the dense tail's transposed solve, then one
    `level_bwd_subst` launch per head level, whichever plan factored L (both
    give the same layout)."""
    _, iperm, _ = sched.on(y.device)
    return backward_sweep(sched, lflat, y)[iperm]


def _refine_with_factor(sched, lflat, ata_flat, b, x0):
    """config.REFINE_STEPS mixed-precision refinement sweeps reusing the
    factor (a no-op unless the high-precision tier is active)."""
    if not refine_active(b.dtype):
        return x0
    with span("tt.subst"):
        tables = sched.pattern.matvec_tables(b.device)
        hp = hp_dtype(b.dtype)
        return refine(
            lambda r: solve_with_factor(sched, lflat, r),
            lambda xv: block_matvec(tables, ata_flat, xv, hp),
            b, x0, config.REFINE_STEPS,
        )


class _SparseBlockSolve(torch.autograd.Function):
    """x = H^{-1} atb with factor reuse (JAX `_solve_fwd` / `_solve_bwd`).

    Backward: `solve_vjp`, its h = H^{-1} g solved with the saved factor
    (plus refinement); d_ata only when asked for."""

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

        def solve(r):  # H is symmetric
            return _refine_with_factor(sched, lflat, ata_flat, r, solve_with_factor(sched, lflat, r))

        with span("tt.backward.solve"):
            d_ata, h = solve_vjp(solve, sched.pattern.matvec_tables(g.device), ata_flat, x, g,
                                 ctx.needs_input_grad[1])
        return None, d_ata, h


def sparse_block_solve(sched: NumericSchedule, ata_flat, atb):
    """x = H^{-1} atb with H the assembled block matrix; differentiable in
    both inputs."""
    if config.needs_grad(ata_flat, atb):
        return _SparseBlockSolve.apply(sched, ata_flat, atb)
    lflat = factorize(sched, ata_flat)
    x = solve_with_factor(sched, lflat, atb)
    return _refine_with_factor(sched, lflat, ata_flat, atb, x)
