"""Batched block-sparse Cholesky: level and per-column plans, factorization, solves, and the solve's backward (JAX counterpart: theseus_tpu/sparse/cholesky.py).

Two numeric plans give one factor value, `Factor`: the head's blocks in
the AoS (nnz_l+1, B, d, d) with slot 0 zero, and the dense tail's matrix:

- the level plan (the default): every elimination-tree level is eliminated
  by one `level_factor` launch, and both substitutions sweep the levels
  with one `level_fwd_subst` / `level_bwd_subst` launch per level (the JAX
  package's `_factorize_levels_pallas` / `_solve_levels_pallas`); each
  launch reads AtA, the factor and the vectors in place through the
  level's int32 record and writes its columns in place, so no gather,
  mask or scatter runs around it;
- the whole-sweep plan (`config.set_whole_sweep(True)`, the JAX package's
  `PALLAS_WHOLE`): one launch per factorization and per substitution sweep
  (sparse/whole.py). Its plain twin is the per-column left-looking plan
  `_factorize_scan` / `_fwd_scan` / `_bwd_scan` (JAX `_factorize_scan`,
  `_solve_scan`, `_bwd_scan`), built on the per-column tables
  `NumericSchedule.a_src ... upd_valid`.

Both plans cover the head columns. When the symbolic analysis amalgamates a
dense trailing supernode (`config.SPARSE_DENSE_TAIL`, any graph denser than
a chain), its K columns are factored after the head by one batched dense
POTRF (`torch.linalg.cholesky_ex`), kept as that dense matrix
(`Factor.tail`) and solved from it by two dense triangular solves, as the
JAX package's `_tail_*` functions do (which also copy it into the tail's
slots of Lflat; here those slots stay zero); the head's level kernels write
the head's L blocks whose rows lie in the tail, and the backward sweep
solves the tail before the head levels read its x. A clique
of 16 or more poses is the tail alone. The whole-sweep plan takes only
schedules without a tail (the JAX gate's rule); a tailed schedule runs the
level plan.

`sparse_block_solve` is differentiable (the JAX package's custom VJP): the
backward reuses the forward's factor for one more solve and launches no
factorization.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..ops.batched_linalg import chol_small, rt_solve_lower, solve_lower_vec, solve_upper_vec
from ..tracing import span
from .assemble import BlockPattern
from .level_kernels import level_bwd_subst, level_factor, level_fwd_subst, level_on, tail_update
from .refine import block_matvec, hp_dtype, refine, refine_active, solve_vjp
from .structure import SymbolicFactor
from .whole import solve_whole, whole_factor


class Factor(NamedTuple):
    """A numeric factor L of a schedule, H = P^T L L^T P: `blocks`, the AoS
    (nnz_l + 1, B, d, d) blocks of the head's columns with slot 0 zero (the
    tail's own slots stay zero), and `tail`, the dense trailing supernode's
    (B, K d, K d) lower factor from its POTRF, None when the schedule has no
    tail."""

    blocks: torch.Tensor
    tail: Optional[torch.Tensor] = None

    def repeat(self, n: int) -> "Factor":
        """n copies folded into the batch, copy-major: batch slot c * B + b."""
        tail = None if self.tail is None else self.tail.repeat(n, 1, 1)
        return Factor(self.blocks.repeat(1, n, 1, 1), tail)


def _index_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy table on `device`: a bool table as a mask, any other as long
    indices."""
    return torch.as_tensor(a, dtype=torch.bool if a.dtype == bool else torch.long, device=device)


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
        - tail_upd_jk / tail_upd_k / tail_upd_valid (K, ue): the external
          left-looking updates, head columns k < n_head with L[cj, k] in the
          pattern (the updates inside the tail are the dense POTRF's own):
          the slot of L[cj, k], k, and the mask of the padding;
        - the `tail_update` kernel's lists, over the K (K + 1) / 2 output
          blocks (j, r >= j) in j-major order: tail_out (n_out, 4) int32
          (j, r, AtA slot, transpose flag), tail_pair_ptr (n_out + 1) int32
          and tail_pairs (n_pairs, 2) int32, the (slot of L[r, k], slot of
          L[j, k]) of every external k where both blocks exist, in the
          order of tail_ext_upd."""
        if self.tail_k == 0:
            self.tail_ue = 0
            return
        sym, pattern = self.sym, self.pattern
        nh, K = self.n_head, self.tail_k
        block_of = sym.block_of
        ext = [[int(k) for k in sym.tail_ext_upd[j]] for j in range(K)]
        ue = max(1, max((len(e) for e in ext), default=1))
        self.tail_ue = ue

        upd_jk = np.zeros((K, ue), dtype=np.int32)
        upd_k = np.zeros((K, ue), dtype=np.int32)
        upd_valid = np.zeros((K, ue), dtype=bool)
        out, ptr, pairs = [], [0], []
        for j in range(K):
            cj = nh + j
            pj = int(sym.perm[cj])
            jk = [block_of[(cj, k)] for k in ext[j]]
            upd_jk[j, :len(jk)] = jk
            upd_k[j, :len(jk)] = ext[j]
            upd_valid[j, :len(jk)] = True
            for r in range(j, K):
                pr = int(sym.perm[nh + r])
                lo, hi = (pr, pj) if pr <= pj else (pj, pr)
                s = pattern.pair_slot.get((lo, hi), 0)
                out.append((j, r, s, pr > pj and s != 0))
                for k, sjk in zip(ext[j], jk):
                    srk = block_of.get((nh + r, k), 0)
                    if srk:
                        pairs.append((srk, sjk))
                ptr.append(len(pairs))

        self.tail_upd_jk = upd_jk
        self.tail_upd_k = upd_k
        self.tail_upd_valid = upd_valid
        self.tail_out = np.asarray(out, dtype=np.int32)
        self.tail_pair_ptr = np.asarray(ptr, dtype=np.int32)
        self.tail_pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)

    def tail_on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The tail tables on `device`, built once per device: the forward
        solve's `upd_jk`, `upd_k`, `upd_valid` (`_index_tensor`) and the
        `tail_update` kernel's int32 lists `out`, `pair_ptr`, `pairs`, so
        that no solve copies an index from the host."""
        key = ("tail", str(device))
        if key not in self._device:
            tables = {k: _index_tensor(getattr(self, f"tail_{k}"), device) for k in ("upd_jk", "upd_k", "upd_valid")}
            for k in ("out", "pair_ptr", "pairs"):
                tables[k] = torch.as_tensor(getattr(self, f"tail_{k}"), device=device)
            self._device[key] = tables
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
            out = {k: _index_tensor(v, device) for k, v in r.items()}
            rmax = r["row_valid"].shape[1]
            out["below"] = _index_tensor(r["row_valid"] & (np.arange(rmax)[None, :] > 0), device)
            out["diag_slots"] = _index_tensor(self.diag_slots, device)
            self._device[key] = out
        return self._device[key]

    def on(self, device: torch.device):
        """(perm, iperm, per-level tables) on `device`, built once per
        device: perm and iperm as long indices, each level's tables as
        `level_kernels.level_on` puts them (int32 indices, bool masks, the
        kernels' record)."""
        key = str(device)
        if key not in self._device:
            levels = [level_on(t, device) for t in self.level_tables]
            self._device[key] = (_index_tensor(self.perm, device), _index_tensor(self.iperm, device), levels)
        return self._device[key]


def factorize_levels(sched: NumericSchedule, ata_flat: torch.Tensor) -> Factor:
    """Level plan: ata_flat (n_slots, B, d, d) -> the Factor: the head level
    by level into its blocks, in place, then the dense tail."""
    _, _, levels = sched.on(ata_flat.device)
    ata_flat = ata_flat.contiguous()
    bsz, d = ata_flat.shape[1], ata_flat.shape[-1]
    lflat = torch.zeros(
        (sched.sym.nnz_l + 1, bsz, d, d), dtype=ata_flat.dtype, device=ata_flat.device
    )
    level_factor(levels, ata_flat, lflat)
    tail = _tail_dense_eliminate(sched, ata_flat, lflat) if sched.tail_k else None
    return Factor(lflat, tail)


def forward_sweep(sched: NumericSchedule, factor: Factor, b_perm):
    """L y = b_perm in elimination order: the head level by level, in
    place, then the dense tail."""
    _, _, levels = sched.on(b_perm.device)
    b_perm = b_perm.contiguous()
    y = torch.zeros_like(b_perm)
    level_fwd_subst(levels, factor.blocks, y, b_perm)
    if sched.tail_k:
        y[sched.n_head:] = _tail_fwd_solve(sched, factor, y, b_perm)
    return y


def backward_sweep(sched: NumericSchedule, factor: Factor, y):
    """L^T x = y in elimination order: the dense tail first (the head's
    columns read its x), then the head levels in reverse, in place."""
    _, _, levels = sched.on(y.device)
    y = y.contiguous()
    x = torch.zeros_like(y)
    if sched.tail_k:
        x[sched.n_head:] = _tail_bwd_solve(sched, factor, y)
    level_bwd_subst(reversed(levels), factor.blocks, x, y)
    return x


def solve_levels(sched: NumericSchedule, factor: Factor, atb: torch.Tensor):
    """Level plan: solve H x = atb given L. atb (n, B, d) original var
    order -> x same."""
    perm, iperm, _ = sched.on(atb.device)
    y = forward_sweep(sched, factor, atb[perm])
    return backward_sweep(sched, factor, y)[iperm]


# ---------------------------------------------------------------------------
# the dense trailing supernode (JAX sparse/cholesky.py `_tail_*`) on
# (B, K d, K d): its external update by `tail_update` (csrc/tail_update.cu,
# plain twin in level_kernels.py), its POTRF and triangular solves plain
# torch. The JAX package computes all of it with jnp outside any Pallas
# kernel.
# ---------------------------------------------------------------------------
def _tail_dense_eliminate(sched: NumericSchedule, ata_flat, lflat):
    """The trailing supernode's dense (B, K d, K d) lower factor: one
    batched POTRF of its matrix after the head's updates (lflat holds the
    head's columns). `cholesky_ex` reports a matrix that is not positive
    definite in `info` without a host sync; such a batch element's tail
    becomes NaN, as jnp.linalg.cholesky gives, so that LM rejects its step.
    Row-major: `solve_triangular` picks its library call, and so its
    rounding, by the layout. The copy is masked in place, so that no more
    than two such matrices are alive at once."""
    ld, info = torch.linalg.cholesky_ex(tail_update(sched, ata_flat, lflat))
    return ld.contiguous().masked_fill_((info != 0)[:, None, None], torch.nan)


def _tail_fwd_solve(sched: NumericSchedule, factor: Factor, y, b_perm):
    """y of the tail columns (K, B, d): the dense lower solve of the
    supernode after subtracting the head's contributions (y holds the
    head's y)."""
    t = sched.tail_on(b_perm.device)
    K, d, nh = sched.tail_k, b_perm.shape[-1], sched.n_head
    yk = torch.where(t["upd_valid"][:, :, None, None], y[t["upd_k"]], 0.0)
    acc = b_perm[nh:] - torch.einsum("kubij,kubj->kbi", factor.blocks[t["upd_jk"]], yk)
    bsz = acc.shape[1]
    rhs = acc.movedim(0, 1).reshape(bsz, K * d, 1)
    yt = torch.linalg.solve_triangular(factor.tail, rhs, upper=False)
    return yt.reshape(bsz, K, d).movedim(1, 0)


def _tail_bwd_solve(sched: NumericSchedule, factor: Factor, y):
    """x of the tail columns (K, B, d): the dense upper solve L^T x = y_tail
    (the tail is eliminated last, so no rows below it contribute)."""
    K, d, nh = sched.tail_k, y.shape[-1], sched.n_head
    bsz = y.shape[1]
    rhs = y[nh:].movedim(0, 1).reshape(bsz, K * d, 1)
    xt = torch.linalg.solve_triangular(factor.tail.transpose(-1, -2), rhs, upper=True)
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


def factorize(sched: NumericSchedule, ata_flat: torch.Tensor) -> Factor:
    """ata_flat (n_slots, B, d, d) -> the Factor, by the plan config
    selects; both plans give the same blocks."""
    with span("tt.factor"):
        if _use_whole(sched):
            return whole_factor(sched, ata_flat)
        return factorize_levels(sched, ata_flat)


def solve_with_factor(sched: NumericSchedule, factor: Factor, atb: torch.Tensor):
    """Solve H x = atb given L. atb (n, B, d) original var order -> x same."""
    with span("tt.subst"):
        if _use_whole(sched):
            return solve_whole(sched, factor, atb)
        return solve_levels(sched, factor, atb)


def sample_with_factor(sched: NumericSchedule, factor: Factor, y: torch.Tensor) -> torch.Tensor:
    """y (n, B, d) iid N(0, 1) in elimination order -> x = P^T L^{-T} y,
    original variable order, whose covariance is H^{-1} (H = P^T L L^T P).
    The backward sweep only: the dense tail's transposed solve, then one
    `level_bwd_subst` launch per head level, whichever plan factored L (both
    give the same blocks)."""
    _, iperm, _ = sched.on(y.device)
    return backward_sweep(sched, factor, y)[iperm]


def _refine_with_factor(sched, factor, ata_flat, b, x0):
    """config.REFINE_STEPS mixed-precision refinement sweeps reusing the
    factor (a no-op unless the high-precision tier is active)."""
    if not refine_active(b.dtype):
        return x0
    with span("tt.subst"):
        tables = sched.pattern.matvec_tables(b.device)
        hp = hp_dtype(b.dtype)
        return refine(
            lambda r: solve_with_factor(sched, factor, r),
            lambda xv: block_matvec(tables, ata_flat, xv, hp),
            b, x0, config.REFINE_STEPS,
        )


class _SparseBlockSolve(torch.autograd.Function):
    """x = H^{-1} atb with factor reuse (JAX `_solve_fwd` / `_solve_bwd`).

    Backward: `solve_vjp`, its h = H^{-1} g solved with the saved factor
    (plus refinement); d_ata only when asked for."""

    @staticmethod
    def forward(ctx, sched, ata_flat, atb):
        factor = factorize(sched, ata_flat)
        x = solve_with_factor(sched, factor, atb)
        x = _refine_with_factor(sched, factor, ata_flat, atb, x)
        ctx.sched = sched
        ctx.save_for_backward(factor.blocks, factor.tail, ata_flat, x)
        return x

    @staticmethod
    def backward(ctx, g):
        sched = ctx.sched
        blocks, tail, ata_flat, x = ctx.saved_tensors
        factor = Factor(blocks, tail)

        def solve(r):  # H is symmetric
            return _refine_with_factor(sched, factor, ata_flat, r, solve_with_factor(sched, factor, r))

        with span("tt.backward.solve"):
            d_ata, h = solve_vjp(solve, sched.pattern.matvec_tables(g.device), ata_flat, x, g,
                                 ctx.needs_input_grad[1])
        return None, d_ata, h


def sparse_block_solve(sched: NumericSchedule, ata_flat, atb):
    """x = H^{-1} atb with H the assembled block matrix; differentiable in
    both inputs."""
    if config.needs_grad(ata_flat, atb):
        return _SparseBlockSolve.apply(sched, ata_flat, atb)
    factor = factorize(sched, ata_flat)
    x = solve_with_factor(sched, factor, atb)
    return _refine_with_factor(sched, factor, ata_flat, atb, x)
