"""Whole-sweep factorization and substitutions: one launch per sweep (JAX counterpart: theseus_tpu/sparse/pallas_whole.py).

Three entry points, each launching its CUDA kernel on a CUDA tensor and
running its plain twin, the per-column left-looking plan of
sparse/cholesky.py, on a CPU tensor:

- `whole_factor(sched, ata)` -> the Factor (`csrc/whole_factor.cu`,
  replaces `_fact_kernel`, pallas_call pallas_whole.py:319);
- `whole_fwd_subst(sched, factor, b)` -> y (`csrc/whole_subst.cu`,
  replaces `_fwd_kernel`, pallas_call :508);
- `whole_bwd_subst(sched, factor, y)` -> x (`csrc/whole_subst.cu`,
  replaces `_bwd_kernel`, pallas_call :523).

The schedule has no dense tail, and the factor (sparse/cholesky.py
`Factor`, its `tail` None) keeps the level plan's AoS blocks
(nnz_l+1, B, d, d) with slot 0 zero, so either plan's solve, the
refinement and the solve's backward take one layout. `b` comes in the
original variable order and `y` leaves in the elimination order; `x` leaves
in the original order: the permutations are folded into the kernels' index
records, so a solve is two launches.

None of the TPU layout carries over: no 128-lane batch padding (and no
identity diagonals in pad lanes), no 8-sublane block padding, no zero
scratch slots, no byte-packed SMEM tables. The index records are int32
arrays in device memory, copied once per device (`WholeTables.on` for the
factor's, `FwdPlan.on` and `BwdPlan.on` for the substitutions').

On the card each kernel gives every batch element its own block and walks
the etree levels inside the kernel (the substitutions in stages of a
level's columns), one barrier per phase: the columns of a level are
independent, so the block's threads share them. The
factor kernel keeps the block's factor in shared memory while it builds it
when the factor and its staged index records fit WHOLE_FACTOR_SMEM_MAX
(`whole_factor_smem_bytes`), and in device memory otherwise.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import _cuda
from ..config import use_kernel
from ..ops.batched_linalg import SMALL_DIM_MAX
from .level_kernels import update_lanes

# Shared-memory budget of one whole_factor block, under the 232,448 bytes a
# block may opt into on the H100: a factor that fits is built there.
WHOLE_FACTOR_SMEM_MAX = 224 * 1024
# Record buffers the kernel stages (WF_STAGES in csrc/whole_factor.cu, whose
# launcher rejects fewer bytes than its layout): level lv in use, lv + 1
# landed, lv + 2 in flight.
WHOLE_FACTOR_STAGES = 3
# whole_fwd_subst and whole_bwd_subst (FwdPlan, BwdPlan): their shared-memory
# budget and the record buffers they stage (csrc/whole_subst.cu
# WS_RECORD_BUFS: stage s in use, s + 1 landed, s + 2 in flight)
WHOLE_SUBST_SMEM_MAX = 224 * 1024
WHOLE_SUBST_RECORD_BUFS = 3


def factor_records(tables: Dict[str, np.ndarray], levels):
    """The whole factor's per-level index records (csrc/whole_factor.cu).

    For a level with nc columns and the level's maxima rl (rows) and ul
    (updates), one int32 run: col_len[nc], ucount[nc], col_slots[nc, rl],
    a_code[nc, rl] = a_src * 2 + a_tr, upd_jk[nc, ul], upd_slots[nc, ul, rl].
    Returns (records concatenated, lvl (n_levels, 4) = (offset, nc, rl, ul),
    the largest record's ints)."""
    runs, lvl, off = [], [], 0
    for cols in levels:
        rl = int(tables["col_len"][cols].max())
        ul = int(tables["ucount"][cols].max())
        run = np.concatenate([
            tables["col_len"][cols],
            tables["ucount"][cols],
            tables["col_slots"][cols, :rl].ravel(),
            (2 * tables["a_src"][cols, :rl] + tables["a_tr"][cols, :rl]).ravel(),
            tables["upd_jk"][cols, :ul].ravel(),
            tables["upd_slots"][cols, :ul, :rl].ravel(),
        ]).astype(np.int32)
        lvl.append((off, len(cols), rl, ul))
        runs.append(run)
        off += len(run)
    rec = np.concatenate(runs) if runs else np.zeros(0, np.int32)
    lvl = np.asarray(lvl, np.int32).reshape(-1, 4)
    return rec, lvl, max((len(r) for r in runs), default=0)


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _balanced_runs(cols, needs, data_bytes):
    """Cut columns (each needing at most data_bytes) into the fewest
    contiguous runs of near-equal length that each fit data_bytes."""
    k = -(-sum(needs) // data_bytes)
    while True:
        cuts = np.array_split(np.arange(len(cols)), k)
        if all(sum(needs[i] for i in c) <= data_bytes for c in cuts):
            return [[cols[i] for i in c] for c in cuts if len(c)]
        k += 1


def level_lanes(tables: Dict[str, np.ndarray], cols) -> int:
    """gu of one etree level: `update_lanes` of its longest update list."""
    return update_lanes(max(1, int(tables["ucount"][cols].max())))


def _sweep_stages(levels, counts, lanes, d: int, itemsize: int, data_bytes: int):
    """Split a substitution sweep's levels, in the order given, into stages,
    each staged whole into one shared-memory buffer of data_bytes
    (csrc/whole_subst.cu).

    counts[j] is column j's list length (its update blocks, or its rows
    below the diagonal), lanes[lv] the lanes that share one output's list
    on level lv. A stage is either a run of whole columns of one level
    (each column's list blocks, its diagonal block and its vector row; a
    level too large for one buffer is cut into runs of near-equal length)
    or, for a column too long for the buffer, one piece of its list: pieces
    of a multiple of the level's lanes, so that each lane keeps its order.
    Returns [(lanes, first, last, [(j, u0, u1)])], first / last marking a
    column's first and last piece (both set for whole columns)."""
    blk, row = d * d * itemsize, d * itemsize
    stages = []
    for cols, gu in zip(levels, lanes):
        run, needs = [], []

        def flush():
            for r in _balanced_runs(run, needs, data_bytes) if run else []:
                stages.append((gu, True, True, r))
            run.clear()
            needs.clear()

        for j, nu in zip(cols, counts[cols]):
            j, nu = int(j), int(nu)
            need = (nu + 1) * blk + row
            if need <= data_bytes:
                run.append((j, 0, nu))
                needs.append(need)
                continue
            flush()
            step = max(gu, (data_bytes - blk - row) // blk // gu * gu)
            for u0 in range(0, nu, step):
                u1 = min(nu, u0 + step)
                stages.append((gu, u0 == 0, u1 == nu, [(j, u0, u1)]))
        flush()
    return stages


def fwd_stages(tables: Dict[str, np.ndarray], levels, d: int, itemsize: int, data_bytes: int):
    """The forward sweep's stages (`_sweep_stages`): the levels in order,
    each column's list its update blocks, gu = `level_lanes` lanes per
    output (the level plan's rule, so that both sum in one order). A
    column's last piece adds its diagonal block and its b row."""
    lanes = [level_lanes(tables, cols) for cols in levels]
    return _sweep_stages(levels, tables["ucount"], lanes, d, itemsize, data_bytes)


def bwd_stages(tables: Dict[str, np.ndarray], levels, d: int, itemsize: int, data_bytes: int):
    """The backward sweep's stages (`_sweep_stages`): the levels last to
    first, each column's list its rows below the diagonal, in order, one
    lane per output. A column's first piece adds its y row, its last piece
    its diagonal block."""
    return _sweep_stages(levels[::-1], tables["col_len"] - 1, [1] * len(levels), d, itemsize, data_bytes)


def _sweep_records(stages, lists, rows, diag, out_row, vec_row):
    """A sweep's per-stage index records (csrc/whole_subst.cu): for a stage
    of nc columns and nb staged blocks, one int32 run
    out[nc] vrow[nc] nu[nc] boff[nc] slot[nb] kk[nb]: the row each column's
    result goes to (out_row[j]), the vector row it starts from
    (vec_row[j]), its blocks in this stage, its first block in the buffer;
    the factor slot of each staged block (the stage's part of the column's
    list lists[j], then its diagonal block diag[j] where the stage holds
    its last piece) and the result row each block multiplies (rows[j]).
    Returns (records, stage table (n_stages, 4) = (offset, nc,
    nb, lanes | first << 6 | last << 7), the largest record's ints)."""
    runs, table, off = [], [], 0
    for gu, first, last, cols in stages:
        out, vrow, nu, boff, slot, kk = [], [], [], [], [], []
        for j, u0, u1 in cols:
            out.append(int(out_row[j]))
            vrow.append(int(vec_row[j]))
            nu.append(u1 - u0)
            boff.append(len(slot))
            slot.extend(lists[j, u0:u1])
            kk.extend(rows[j, u0:u1])
            if last:
                slot.append(int(diag[j]))
                kk.append(0)
        run = np.asarray(out + vrow + nu + boff + [int(s) for s in slot] + [int(k) for k in kk], np.int32)
        table.append((off, len(out), len(slot), gu | int(first) << 6 | int(last) << 7))
        runs.append(run)
        off += len(run)
    rec = np.concatenate(runs) if runs else np.zeros(0, np.int32)
    table = np.asarray(table, np.int32).reshape(-1, 4)
    return rec, table, max((len(r) for r in runs), default=0)


def fwd_records(tables: Dict[str, np.ndarray], stages):
    """The forward sweep's records (`_sweep_records`): y_j is written at
    row j (elimination order) from b row perm[j] (original order); the list
    is the update blocks upd_jk[j] and the y rows upd_k[j] they multiply;
    the b rows arrive with a column's last piece."""
    ident = np.arange(len(tables["perm"]))
    return _sweep_records(stages, tables["upd_jk"], tables["upd_k"], tables["diag"], ident, tables["perm"])


def bwd_records(tables: Dict[str, np.ndarray], stages):
    """The backward sweep's records (`_sweep_records`): x_j is written at
    row perm[j] (the original order, where the kernel keeps x) from y row j
    (elimination order); the list is the column's blocks below the
    diagonal, col_slots[j, 1:], and the x rows perm[row_ids[j, 1:]] they
    multiply; the diagonal block is col_slots[j, 0]; the y rows arrive with
    a column's first piece."""
    perm = tables["perm"]
    ident = np.arange(len(perm))
    return _sweep_records(stages, tables["col_slots"][:, 1:], perm[tables["row_ids"][:, 1:]],
                          tables["col_slots"][:, 0], perm, ident)


class _SweepPlan:
    """Launch plan of one whole substitution sweep for one (d, dtype): the
    stages and records, whether the block keeps the vector it solves for
    in shared memory (`vec_smem`) and the shared-memory bytes.

    The shared memory holds that vector (n d values, 16-byte rounded) when
    it fits, two stage buffers (buf_vals values each: a stage's blocks, then
    its vector rows) and WHOLE_SUBST_RECORD_BUFS record buffers, within
    WHOLE_SUBST_SMEM_MAX (`_fit`); if no stage fits beside the vector, it
    stays in device memory."""

    def __init__(self, tb: "WholeTables", d: int, itemsize: int, stages_fn, records_fn, gu_max: int):
        fit = self._fit(tb, d, itemsize, _round16(tb.n * d * itemsize), gu_max, stages_fn, records_fn)
        self.vec_smem = fit is not None
        fit = fit or self._fit(tb, d, itemsize, 0, gu_max, stages_fn, records_fn)
        if fit is None:
            raise ValueError(f"{type(self).__name__}: no stage fits the shared-memory budget")
        self.stages, (self.rec, self.table, self.stage_ints), self.buf_vals, self.smem = fit
        self.n_stages = len(self.stages)
        self._device: Dict[str, Dict[str, torch.Tensor]] = {}

    @staticmethod
    def _fit(tb, d, itemsize, v_bytes, gu_max, stages_fn, records_fn):
        """(stages, records, buffer values, smem bytes) with v_bytes of the
        vector beside the buffers, or None when not even a piece of gu_max
        blocks fits. A record costs at most r bytes per staged byte (16 per
        column, which stages a block and a vector row at least, and 8 per
        further block), so a stage buffer of
        (budget - v_bytes - 32) / (2 + RECORD_BUFS r) bytes fits with its
        records (32: the buffers' rounding to 16 bytes)."""
        blk, row = d * d * itemsize, d * itemsize
        r = max(24 / (blk + row), 8 / blk)
        data = int((WHOLE_SUBST_SMEM_MAX - v_bytes - 32) / (2 + WHOLE_SUBST_RECORD_BUFS * r))
        if data < (gu_max + 1) * blk + row:
            return None
        stages = stages_fn(tb.host, tb.levels, d, itemsize, data)
        records = records_fn(tb.host, stages)
        table, stage_ints = records[1], records[2]
        buf_vals = int((table[:, 2] * d * d + table[:, 1] * d).max(initial=0))
        smem = v_bytes + 2 * _round16(buf_vals * itemsize) + WHOLE_SUBST_RECORD_BUFS * 4 * stage_ints
        assert smem <= WHOLE_SUBST_SMEM_MAX, (smem, WHOLE_SUBST_SMEM_MAX)
        return stages, records, buf_vals, smem

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._device:
            self._device[key] = {"rec": torch.as_tensor(self.rec, device=device),
                                 "table": torch.as_tensor(self.table, device=device)}
        return self._device[key]


class FwdPlan(_SweepPlan):
    """`whole_fwd_subst`'s plan (`fwd_stages`, `fwd_records`); gu: the
    lanes per output of each level. vec_smem: y in shared memory."""

    def __init__(self, tb: "WholeTables", d: int, itemsize: int):
        self.gu = [level_lanes(tb.host, c) for c in tb.levels]
        super().__init__(tb, d, itemsize, fwd_stages, fwd_records, max(self.gu, default=1))


class BwdPlan(_SweepPlan):
    """`whole_bwd_subst`'s plan (`bwd_stages`, `bwd_records`). vec_smem: x
    in shared memory."""

    def __init__(self, tb: "WholeTables", d: int, itemsize: int):
        super().__init__(tb, d, itemsize, bwd_stages, bwd_records, 1)


def whole_factor_smem_bytes(sched, d: int, itemsize: int) -> int:
    """Shared memory whole_factor's block needs to keep the factor there:
    the factor ((nnz_l + 1) d^2 values, rounded up to 16 bytes), the level
    table (16 bytes a level) and WHOLE_FACTOR_STAGES buffers of the largest
    level record."""
    t = get_tables(sched)
    factor = -(-(sched.sym.nnz_l + 1) * d * d * itemsize // 16) * 16
    return factor + 16 * t.n_levels + WHOLE_FACTOR_STAGES * t.stage_ints * 4


def whole_factor_variant(sched, d: int, itemsize: int) -> str:
    """"shared" when the factor is built in shared memory, else "device"."""
    return "shared" if whole_factor_smem_bytes(sched, d, itemsize) <= WHOLE_FACTOR_SMEM_MAX else "device"


class WholeTables:
    """Static int32 tables of the whole-sweep kernels, from a NumericSchedule.

    Per column j (elimination order), rmax rows and umax updates:
    col_slots (n, rmax) factor slots of the column (row 0 the diagonal
    block); col_len (n) valid rows, packed at the front; row_ids (n, rmax)
    the rows' indices; ucount (n) valid updates, packed at the front; upd_jk
    (n, umax) slot of L[j, k]; upd_k (n, umax) the source column k; diag (n)
    the diagonal slot; perm (n); `levels`, the columns of each etree level.
    The substitutions' records come from these (`fwd_plan`, `bwd_plan`); the
    factor kernel's per-level records are `fact_rec`, `fact_lvl`
    (`factor_records`)."""

    def __init__(self, sched):
        nh = sched.n_head
        self.n = nh
        col_len = sched.row_valid.sum(axis=1)
        ucount = sched.upd_valid.sum(axis=1)
        if not all(sched.row_valid[j, : col_len[j]].all() for j in range(nh)):
            raise ValueError("whole-sweep tables: column rows are not packed at the front")
        if not all(sched.upd_valid[j, : ucount[j]].all() for j in range(nh)):
            raise ValueError("whole-sweep tables: column updates are not packed at the front")
        self.levels = levels = [np.asarray(c, np.int64) for c in sched.sym.levels]
        order = np.concatenate(levels) if levels else np.zeros(0, np.int64)
        if sorted(order.tolist()) != list(range(nh)):
            raise ValueError("whole-sweep tables: the etree levels do not cover the columns once")
        i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
        self.host: Dict[str, np.ndarray] = {
            "col_slots": i32(sched.col_slots),
            "col_len": i32(col_len),
            "row_ids": i32(sched.col_row_ids),
            "ucount": i32(ucount),
            "upd_jk": i32(sched.upd_jk_slots),
            "upd_k": i32(sched.upd_k),
            "diag": i32(sched.diag_slots),
            "perm": i32(sched.perm),
        }
        rec, lvl, self.stage_ints = factor_records(
            dict(self.host, a_src=i32(sched.a_src), a_tr=i32(sched.a_tr), upd_slots=i32(sched.upd_slots)),
            levels)
        self.host["fact_rec"], self.host["fact_lvl"] = rec, lvl
        self.n_levels = len(levels)
        self._plans: Dict[tuple, _SweepPlan] = {}
        self._device: Dict[str, Dict[str, torch.Tensor]] = {}

    def _plan(self, cls, d: int, itemsize: int):
        key = (cls, d, itemsize)
        if key not in self._plans:
            self._plans[key] = cls(self, d, itemsize)
        return self._plans[key]

    def fwd_plan(self, d: int, itemsize: int) -> FwdPlan:
        """The forward sweep's plan for blocks of d x d values of itemsize bytes."""
        return self._plan(FwdPlan, d, itemsize)

    def bwd_plan(self, d: int, itemsize: int) -> BwdPlan:
        """The backward sweep's plan for blocks of d x d values of itemsize bytes."""
        return self._plan(BwdPlan, d, itemsize)

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The factor kernel's records (`fact_rec`, `fact_lvl`) on `device`,
        copied once a device."""
        key = str(device)
        if key not in self._device:
            self._device[key] = {k: torch.as_tensor(self.host[k], device=device) for k in ("fact_rec", "fact_lvl")}
        return self._device[key]


def get_tables(sched) -> WholeTables:
    t = getattr(sched, "_whole_tables", None)
    if t is None:
        t = WholeTables(sched)
        sched._whole_tables = t
    return t


def _fn(name, t: torch.Tensor, d: int):
    if d > SMALL_DIM_MAX:
        raise ValueError(f"{name}: the CUDA kernel takes blocks of d <= {SMALL_DIM_MAX}, got {d}")
    return getattr(_cuda.lib(), f"th_{name}_{_cuda.suffix(t.dtype)}")


def _check(name, *operands):
    """operands: (tensor, expected shape) pairs on one device and dtype."""
    dev, dt = operands[0][0].device, operands[0][0].dtype
    for t, shape in operands:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands must share device and dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def whole_factor(sched, ata: torch.Tensor):
    """ata (n_slots, B, d, d) -> the Factor, its blocks (nnz_l+1, B, d, d)
    with slot 0 zero."""
    from .cholesky import Factor, _factorize_scan

    if not use_kernel(ata):
        return Factor(_factorize_scan(sched, ata))
    tb = get_tables(sched)
    bsz, d = ata.shape[1], ata.shape[-1]
    _check("whole_factor", (ata, (sched.pattern.n_slots, bsz, d, d)))
    fn = _fn("whole_factor", ata, d)
    t = tb.on(ata.device)
    smem = whole_factor_smem_bytes(sched, d, ata.element_size())
    if smem > WHOLE_FACTOR_SMEM_MAX:
        smem = 0  # the device-memory variant
    ata = ata.contiguous()
    lflat = torch.empty((sched.sym.nnz_l + 1, bsz, d, d), dtype=ata.dtype, device=ata.device)
    with torch.cuda.device(ata.device):
        rc = fn(ata.data_ptr(), t["fact_rec"].data_ptr(), t["fact_lvl"].data_ptr(), tb.n_levels,
                sched.sym.nnz_l + 1, tb.stage_ints, smem, bsz, d, lflat.data_ptr(),
                _cuda.stream_of(ata))
    _cuda.check(rc, "whole_factor")
    _cuda.launches["whole_factor"] += 1
    return Factor(lflat)


def whole_fwd_subst(sched, factor, b: torch.Tensor) -> torch.Tensor:
    """L y = b[perm]: b (n, B, d) in the original variable order -> y
    (n, B, d) in the elimination order."""
    lflat = factor.blocks
    if not use_kernel(lflat):
        from .cholesky import _fwd_scan

        perm, _, _ = sched.on(b.device)
        return _fwd_scan(sched, lflat, b[perm])
    tb = get_tables(sched)
    bsz, d = lflat.shape[1], lflat.shape[-1]
    _check("whole_fwd_subst", (lflat, (sched.sym.nnz_l + 1, bsz, d, d)), (b, (tb.n, bsz, d)))
    fn = _fn("whole_fwd_subst", lflat, d)
    plan = tb.fwd_plan(d, lflat.element_size())
    t = plan.on(lflat.device)
    lflat, b = lflat.contiguous(), b.contiguous()
    y = torch.empty_like(b)
    with torch.cuda.device(lflat.device):
        rc = fn(lflat.data_ptr(), b.data_ptr(), t["rec"].data_ptr(), t["table"].data_ptr(), plan.n_stages,
                plan.stage_ints, plan.buf_vals, tb.n, bsz, d, int(plan.vec_smem),
                plan.smem, y.data_ptr(), _cuda.stream_of(lflat))
    _cuda.check(rc, "whole_fwd_subst")
    _cuda.launches["whole_fwd_subst"] += 1
    return y


def whole_bwd_subst(sched, factor, y: torch.Tensor) -> torch.Tensor:
    """L^T x = y: y (n, B, d) in the elimination order -> x (n, B, d) in the
    original variable order."""
    lflat = factor.blocks
    if not use_kernel(lflat):
        from .cholesky import _bwd_scan

        _, iperm, _ = sched.on(y.device)
        return _bwd_scan(sched, lflat, y)[iperm]
    tb = get_tables(sched)
    bsz, d = lflat.shape[1], lflat.shape[-1]
    _check("whole_bwd_subst", (lflat, (sched.sym.nnz_l + 1, bsz, d, d)), (y, (tb.n, bsz, d)))
    fn = _fn("whole_bwd_subst", lflat, d)
    plan = tb.bwd_plan(d, lflat.element_size())
    t = plan.on(lflat.device)
    lflat, y = lflat.contiguous(), y.contiguous()
    x = torch.empty_like(y)
    with torch.cuda.device(lflat.device):
        rc = fn(lflat.data_ptr(), y.data_ptr(), t["rec"].data_ptr(), t["table"].data_ptr(), plan.n_stages,
                plan.stage_ints, plan.buf_vals, tb.n, bsz, d, int(plan.vec_smem),
                plan.smem, x.data_ptr(), _cuda.stream_of(lflat))
    _cuda.check(rc, "whole_bwd_subst")
    _cuda.launches["whole_bwd_subst"] += 1
    return x


def solve_whole(sched, factor, b: torch.Tensor) -> torch.Tensor:
    """H x = b with the factor: b and x (n, B, d) in the original order."""
    return whole_bwd_subst(sched, factor, whole_fwd_subst(sched, factor, b))
