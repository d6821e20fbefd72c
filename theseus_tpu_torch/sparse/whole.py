"""Whole-sweep factorization and substitutions: one launch per sweep (JAX counterpart: theseus_tpu/sparse/pallas_whole.py).

Three entry points, each launching its CUDA kernel on a CUDA tensor and
running its plain twin, the per-column left-looking plan of
sparse/cholesky.py, on a CPU tensor:

- `whole_factor(sched, ata)` -> Lflat (`csrc/whole_factor.cu`,
  replaces `_fact_kernel`, pallas_call pallas_whole.py:319);
- `whole_fwd_subst(sched, lflat, b)` -> y (`csrc/whole_subst.cu`,
  replaces `_fwd_kernel`, pallas_call :508);
- `whole_bwd_subst(sched, lflat, y)` -> x (`csrc/whole_subst.cu`,
  replaces `_bwd_kernel`, pallas_call :523).

The factor keeps the level plan's AoS layout (nnz_l+1, B, d, d) with slot 0
zero, so either plan's solve, the refinement and the solve's backward take
one layout. `b` comes in the original variable order and `y` leaves in the
elimination order; `x` leaves in the original order: the permutations are
read inside the kernels, so a solve is three launches.

None of the TPU layout carries over: no 128-lane batch padding (and no
identity diagonals in pad lanes), no 8-sublane block padding, no zero
scratch slots, no byte-packed SMEM tables. The tables are int32 arrays in
device memory, built once per device by `WholeTables.on`.

On the card each kernel gives every batch element its own block and walks
the etree levels inside the kernel, one barrier per phase of a level: the
columns of a level are independent, so the block's threads share them. The
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
# whole_fwd_subst (FwdPlan): its shared-memory budget and the record buffers
# it stages (csrc/whole_subst.cu WFS_RECORD_BUFS: stage s in use, s + 1
# landed, s + 2 in flight)
WHOLE_FWD_SMEM_MAX = 224 * 1024
WHOLE_FWD_RECORD_BUFS = 3


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


def fwd_stages(tables: Dict[str, np.ndarray], levels, d: int, itemsize: int, data_bytes: int):
    """Split the forward sweep's levels into stages, each staged whole into
    one shared-memory buffer of data_bytes (csrc/whole_subst.cu).

    Per level, gu = `level_lanes` (the level plan's rule, so that both sum
    in one order). A stage is either a
    run of whole columns of one level (each column's update blocks, its
    diagonal block and its b row; a level too large for one buffer is cut
    into runs of near-equal length) or, for a column too long for the
    buffer, one piece of its update list: pieces of a multiple of gu
    updates, so that each lane keeps its order; the last piece adds the
    diagonal block and the b row. Returns [(gu, first, last, [(j, u0, u1)])],
    first / last marking a column's first and last piece (both set for
    whole columns)."""
    blk, row = d * d * itemsize, d * itemsize
    stages = []
    for cols in levels:
        gu = level_lanes(tables, cols)
        run, needs = [], []

        def flush():
            for r in _balanced_runs(run, needs, data_bytes) if run else []:
                stages.append((gu, True, True, r))
            run.clear()
            needs.clear()

        for j, nu in zip(cols, tables["ucount"][cols]):
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


def fwd_records(tables: Dict[str, np.ndarray], stages):
    """The forward sweep's per-stage index records (csrc/whole_subst.cu):
    for a stage of nc columns and nb staged blocks, one int32 run
    col[nc] brow[nc] nu[nc] boff[nc] slot[nb] kk[nb]: the column, its b row
    (its original variable index), its updates in this stage, its first
    block in the buffer; the factor slot of each staged block (a column's
    updates, then its diagonal block where the stage holds its last piece)
    and the y row each update block multiplies. Returns (records, stage
    table (n_stages, 4) = (offset, nc, nb, gu | first << 6 | last << 7),
    the largest record's ints)."""
    runs, table, off = [], [], 0
    for gu, first, last, cols in stages:
        col, brow, nu, boff, slot, kk = [], [], [], [], [], []
        for j, u0, u1 in cols:
            col.append(j)
            brow.append(int(tables["perm"][j]))
            nu.append(u1 - u0)
            boff.append(len(slot))
            slot.extend(tables["upd_jk"][j, u0:u1])
            kk.extend(tables["upd_k"][j, u0:u1])
            if last:
                slot.append(int(tables["diag"][j]))
                kk.append(0)
        run = np.asarray(col + brow + nu + boff + [int(s) for s in slot] + [int(k) for k in kk], np.int32)
        table.append((off, len(col), len(slot), gu | int(first) << 6 | int(last) << 7))
        runs.append(run)
        off += len(run)
    rec = np.concatenate(runs) if runs else np.zeros(0, np.int32)
    table = np.asarray(table, np.int32).reshape(-1, 4)
    return rec, table, max((len(r) for r in runs), default=0)


class FwdPlan:
    """Launch plan of `whole_fwd_subst` for one (d, dtype): the stages and
    records (`fwd_stages`, `fwd_records`), whether the block keeps y in
    shared memory and the shared-memory bytes.

    The shared memory holds y (n d values, 16-byte rounded) when it fits,
    two stage buffers (buf_vals values each: a stage's blocks, then its b
    rows) and WHOLE_FWD_RECORD_BUFS record buffers, within
    WHOLE_FWD_SMEM_MAX (`_fit`); if no stage fits beside y, y stays in
    device memory."""

    def __init__(self, tb: "WholeTables", d: int, itemsize: int):
        self.gu = [level_lanes(tb.host, c) for c in tb.levels]
        gu_max = max(self.gu, default=1)
        fit = self._fit(tb, d, itemsize, _round16(tb.n * d * itemsize), gu_max)
        self.y_smem = fit is not None
        fit = fit or self._fit(tb, d, itemsize, 0, gu_max)
        if fit is None:
            raise ValueError("whole_fwd_subst: no stage fits the shared-memory budget")
        self.stages, (self.rec, self.table, self.stage_ints), self.buf_vals, self.smem = fit
        self.n_stages = len(self.stages)
        self._device: Dict[str, Dict[str, torch.Tensor]] = {}

    @staticmethod
    def _fit(tb, d, itemsize, y_bytes, gu_max):
        """(stages, records, buffer values, smem bytes) with y_bytes of y beside the
        buffers, or None when not even a piece of gu_max updates fits. A
        record costs at most r bytes per staged byte (16 per column, which
        stages a block and a b row at least, and 8 per further block), so a
        stage buffer of (budget - y - 32) / (2 + RECORD_BUFS r) bytes fits
        with its records (32: the buffers' rounding to 16 bytes)."""
        blk, row = d * d * itemsize, d * itemsize
        r = max(24 / (blk + row), 8 / blk)
        data = int((WHOLE_FWD_SMEM_MAX - y_bytes - 32) / (2 + WHOLE_FWD_RECORD_BUFS * r))
        if data < (gu_max + 1) * blk + row:
            return None
        stages = fwd_stages(tb.host, tb.levels, d, itemsize, data)
        records = fwd_records(tb.host, stages)
        table, stage_ints = records[1], records[2]
        buf_vals = int((table[:, 2] * d * d + table[:, 1] * d).max(initial=0))
        smem = y_bytes + 2 * _round16(buf_vals * itemsize) + WHOLE_FWD_RECORD_BUFS * 4 * stage_ints
        assert smem <= WHOLE_FWD_SMEM_MAX, (smem, WHOLE_FWD_SMEM_MAX)
        return stages, records, buf_vals, smem

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._device:
            self._device[key] = {"rec": torch.as_tensor(self.rec, device=device),
                                 "table": torch.as_tensor(self.table, device=device)}
        return self._device[key]


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
    the diagonal slot; perm (n). The level walk: `order`, the columns
    grouped by etree level, and `lvl_ptr` (levels + 1) into it. The factor
    kernel's per-level records: `fact_rec`, `fact_lvl` (`factor_records`)."""

    def __init__(self, sched):
        nh = sched.n_head
        self.n = nh
        self.rmax = int(sched.a_src.shape[1])
        self.umax = int(sched.upd_slots.shape[1])
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
            "order": i32(order),
            "lvl_ptr": i32(np.concatenate([[0], np.cumsum([len(c) for c in levels])])),
        }
        rec, lvl, self.stage_ints = factor_records(
            dict(self.host, a_src=i32(sched.a_src), a_tr=i32(sched.a_tr), upd_slots=i32(sched.upd_slots)),
            levels)
        self.host["fact_rec"], self.host["fact_lvl"] = rec, lvl
        self.n_levels = len(levels)
        self._fwd_plans: Dict[tuple, FwdPlan] = {}
        self._device: Dict[str, Dict[str, torch.Tensor]] = {}

    def fwd_plan(self, d: int, itemsize: int) -> FwdPlan:
        """The forward sweep's plan for blocks of d x d values of itemsize bytes."""
        key = (d, itemsize)
        if key not in self._fwd_plans:
            self._fwd_plans[key] = FwdPlan(self, *key)
        return self._fwd_plans[key]

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        key = str(device)
        if key not in self._device:
            self._device[key] = {
                k: torch.as_tensor(v, device=device) for k, v in self.host.items()
            }
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


def whole_factor(sched, ata: torch.Tensor) -> torch.Tensor:
    """ata (n_slots, B, d, d) -> Lflat (nnz_l+1, B, d, d), slot 0 zero."""
    if not use_kernel(ata):
        from .cholesky import _factorize_scan

        return _factorize_scan(sched, ata)
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
    return lflat


def whole_fwd_subst(sched, lflat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L y = b[perm]: b (n, B, d) in the original variable order -> y
    (n, B, d) in the elimination order."""
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
                plan.stage_ints, plan.buf_vals, tb.n, bsz, d, int(plan.y_smem),
                plan.smem, y.data_ptr(), _cuda.stream_of(lflat))
    _cuda.check(rc, "whole_fwd_subst")
    _cuda.launches["whole_fwd_subst"] += 1
    return y


def whole_bwd_subst(sched, lflat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L^T x = y: y (n, B, d) in the elimination order -> x (n, B, d) in the
    original variable order."""
    if not use_kernel(lflat):
        from .cholesky import _bwd_scan

        _, iperm, _ = sched.on(y.device)
        return _bwd_scan(sched, lflat, y)[iperm]
    tb = get_tables(sched)
    bsz, d = lflat.shape[1], lflat.shape[-1]
    _check("whole_bwd_subst", (lflat, (sched.sym.nnz_l + 1, bsz, d, d)), (y, (tb.n, bsz, d)))
    fn = _fn("whole_bwd_subst", lflat, d)
    t = tb.on(lflat.device)
    lflat, y = lflat.contiguous(), y.contiguous()
    x = torch.empty_like(y)
    with torch.cuda.device(lflat.device):
        rc = fn(lflat.data_ptr(), y.data_ptr(), t["perm"].data_ptr(), t["col_slots"].data_ptr(),
                t["col_len"].data_ptr(), t["row_ids"].data_ptr(), t["order"].data_ptr(),
                t["lvl_ptr"].data_ptr(), tb.n_levels, tb.n, tb.rmax, bsz, d, x.data_ptr(),
                _cuda.stream_of(lflat))
    _cuda.check(rc, "whole_bwd_subst")
    _cuda.launches["whole_bwd_subst"] += 1
    return x


def solve_whole(sched, lflat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H x = b with the factor: b and x (n, B, d) in the original order."""
    return whole_bwd_subst(sched, lflat, whole_fwd_subst(sched, lflat, b))
