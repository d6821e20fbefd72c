"""Per-level factor and substitution, and the dense tail's external update: CUDA kernels and plain twins (JAX counterpart: theseus_tpu/sparse/pallas_factorize.py; the tail's update is jnp in sparse/cholesky.py).

Four entry points, each launching its kernel on CUDA tensors and running
its plain twin on CPU tensors:

- `level_factor(levels, ata_flat, lflat)`: eliminates each level's columns
  into the factor lflat, in place (`csrc/level_factor.cu`)
- `level_fwd_subst(levels, lflat, y, b)`: y's rows of each level's
  columns, in place (`csrc/level_subst.cu`)
- `level_bwd_subst(levels, lflat, x, y)`: x's rows likewise, the levels in
  the order given (`csrc/level_subst.cu`)
- `tail_update(sched, ata_flat, lflat)` -> the dense trailing supernode's
  symmetric matrix before its POTRF (`csrc/tail_update.cu`)

`levels` is a sequence of level tables as `level_on` puts them on a device
(`NumericSchedule.on`); the kernels take one launch a level and read their
operands in place through the level's int32 record (`level_record`), as
`tail_update` reads its lists (`NumericSchedule.tail_on`). Arrays are AoS
with the batch before the block: AtA (n_slots, B, d, d), the factor
(nnz_l + 1, B, d, d) with slot 0 the zero block, vectors (n, B, d) in
elimination order. The twins gather the same operands and follow the JAX
package's `_factorize_levels` / `_solve_levels` arithmetic through the
unrolled ops/batched_linalg routines. The substitution kernels' launch
geometry is chosen here (`fwd_subst_geometry`, `bwd_subst_geometry`), where
the CPU tests reach it. `LevelStage` holds one level stage's arrays, for
the checks of a kernel against its twin on given operands.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import _cuda
from ..config import use_kernel
from ..ops.batched_linalg import (
    SMALL_DIM_MAX,
    chol_small,
    rt_solve_lower,
    solve_lower_vec,
    solve_upper_vec,
)

# the substitution kernels' geometry (fwd_subst_geometry, bwd_subst_geometry)
WARP = 32
FWD_TILE_MAX = 32  # batch elements a block
FWD_THREADS_MAX = 1024
FWD_BLOCKS_PER_SM = 2  # the tile shrinks until the launch fills each SM this often
FWD_SMEM_MAX = 48 * 1024  # the launcher's limit (no opt-in)


# ---------------------------------------------------------------------------
# the level tables on a device
# ---------------------------------------------------------------------------
def _prefix_counts(mask: np.ndarray, what: str) -> np.ndarray:
    """Per row of a (C, m) mask, its count of True, which must lead the row."""
    n = mask.sum(axis=1)
    if not (mask == (np.arange(mask.shape[1])[None, :] < n[:, None])).all():
        raise ValueError(f"level table: the valid {what} of a column must come first")
    return n


# The sections of a level's int32 record, in the order csrc/common.cuh
# LevelRecord reads them: (name, shape over (C, rl, ul)).
_SECTIONS = (("cols", "c"), ("nrow", "c"), ("nupd", "c"), ("diag_slots", "c"), ("a_src", "cr"),
             ("col_slots", "cr"), ("row_ids", "cr"), ("jk_slots", "cu"), ("upd_k", "cu"), ("upd_slots", "cur"))


def level_record(t) -> np.ndarray:
    """The int32 record the level kernels read (`_SECTIONS`, csrc/common.cuh
    LevelRecord) of one level's numpy tables (NumericSchedule's
    `_build_level_table`), C columns padded to rl rows and ul updates: cols,
    the valid rows and updates of each column (prefixes), diag_slots (C
    each); a_src with the transposed slots negated, col_slots, row_ids
    (C x rl each); jk_slots, upd_k (C x ul each); upd_slots (C x ul x rl)."""
    nrow = _prefix_counts(t["valid"], "rows")
    if (nrow < 1).any():
        raise ValueError("level table: every column has its diagonal row")
    parts = dict(t, nrow=nrow, nupd=_prefix_counts(t["upd_valid"], "updates"),
                 a_src=np.where(t["a_tr"], -t["a_src"], t["a_src"]))
    return np.concatenate([np.asarray(parts[name], dtype=np.int32).ravel() for name, _ in _SECTIONS])


def level_on(t, device) -> dict:
    """One level's numpy tables on `device`, built once per schedule and
    device: the kernels' int32 `rec` (`level_record`), its sections as
    views under their names (so `a_src` is negated where `a_tr`), the masks
    as bool (the twins gather through these), the backward's `below` mask
    (valid rows under the diagonal), `dims` (C, rl, ul) and `need`, the rows
    of AtA, the factor and a vector the tables reach."""
    C, rl = t["valid"].shape
    ul = t["upd_valid"].shape[1]
    rec = torch.as_tensor(level_record(t), device=device)
    shapes = {"c": (C,), "cr": (C, rl), "cu": (C, ul), "cur": (C, ul, rl)}
    out, off = {"rec": rec, "dims": (C, rl, ul)}, 0
    for name, kind in _SECTIONS:
        n = int(np.prod(shapes[kind]))
        out[name] = rec[off:off + n].view(shapes[kind])
        off += n
    for k in ("a_tr", "valid", "row_valid", "upd_valid"):
        out[k] = torch.as_tensor(t[k], device=device)
    out["below"] = torch.as_tensor(t["row_valid"] & (np.arange(rl)[None, :] > 0), device=device)
    slots = [t[k].max(initial=0) for k in ("col_slots", "jk_slots", "upd_slots", "diag_slots")]
    rows = [t[k].max(initial=0) for k in ("cols", "row_ids", "upd_k")]
    out["need"] = (int(t["a_src"].max(initial=0)) + 1, int(max(slots)) + 1, int(max(rows)) + 1)
    return out


# ---------------------------------------------------------------------------
# plain twins: the kernels' arithmetic on gathered operands, in place
# ---------------------------------------------------------------------------
def factor_operands(t, ata_flat, lflat):
    """A level's (col_a (C, rl, B, d, d) from AtA's slots |a_src|, transposed
    where a_tr;
    ks (C, ul, rl, B, d, d) and kj (C, ul, B, d, d) from the factor)."""
    col_a = ata_flat[t["a_src"].abs()]
    col_a = torch.where(t["a_tr"][:, :, None, None, None], col_a.transpose(-1, -2), col_a)
    return col_a, lflat[t["upd_slots"]], lflat[t["jk_slots"]]


def fwd_operands(t, lflat, y, b):
    """A level's (ljk, yk with the padded updates zero, b, ldiag)."""
    yk = torch.where(t["upd_valid"][:, :, None, None], y[t["upd_k"]], 0.0)
    return lflat[t["jk_slots"]], yk, b[t["cols"]], lflat[t["diag_slots"]]


def bwd_operands(t, lflat, x, y):
    """A level's (lcol, xr with row 0 and the padded rows zero, y)."""
    xr = torch.where(t["below"][:, :, None, None], x[t["row_ids"]], 0.0)
    return lflat[t["col_slots"]], xr, y[t["cols"]]


def level_factor_plain(levels: Sequence[dict], ata_flat, lflat):
    """For each level in order: [chol(sym(C_0)), C_r L^{-T}] with
    C = col_a - sum_u ks kj^T (`factor_operands`) into the factor's slots of
    the valid rows."""
    for t in levels:
        col_a, ks, kj = factor_operands(t, ata_flat, lflat)
        c = col_a - torch.einsum("curbik,cubjk->crbij", ks, kj)
        ld = chol_small(0.5 * (c[:, 0] + c[:, 0].transpose(-1, -2)))
        newcol = torch.cat([ld[:, None], rt_solve_lower(ld[:, None], c[:, 1:])], dim=1)
        valid = t["valid"]
        lflat[t["col_slots"][valid]] = newcol[valid]


def level_fwd_subst_plain(levels: Sequence[dict], lflat, y, b):
    """For each level in order: y_j = L_jj^{-1} (b_j - sum_u L_jk y_k)
    (`fwd_operands`) into y's rows of its columns."""
    for t in levels:
        ljk, yk, bc, ldiag = fwd_operands(t, lflat, y, b)
        y[t["cols"]] = solve_lower_vec(ldiag, bc - torch.einsum("cubij,cubj->cbi", ljk, yk))


def level_bwd_subst_plain(levels: Sequence[dict], lflat, x, y):
    """For each level in the order given: x_j = L_jj^{-T} (y_j - sum_{r>=1}
    L_rj^T x_r) (`bwd_operands`) into x's rows of its columns."""
    for t in levels:
        lcol, xr, yc = bwd_operands(t, lflat, x, y)
        acc = yc - torch.einsum("crbij,crbi->cbj", lcol[:, 1:], xr[:, 1:])
        x[t["cols"]] = solve_upper_vec(lcol[:, 0].transpose(-1, -2), acc)


def tail_update_plain(t, ata_flat, lflat):
    """t: `NumericSchedule.tail_on`'s tables. The kernel's arithmetic from
    its lists: for each output block (j, r >= j) C = A - sum of
    L[r, k] L[j, k]^T over its pairs, then the symmetric dense
    (B, K d, K d): C at block (r, j), C^T at (j, r), the diagonal blocks as
    0.5 (C + C^T)."""
    K, bsz, d = t["upd_jk"].shape[0], ata_flat.shape[1], ata_flat.shape[-1]
    out, pairs = t["out"].long(), t["pairs"].long()
    seg = torch.repeat_interleave(torch.arange(out.shape[0], device=out.device), t["pair_ptr"].diff())
    prod = lflat[pairs[:, 0]] @ lflat[pairs[:, 1]].transpose(-1, -2)
    acc = torch.zeros((out.shape[0], bsz, d, d), dtype=prod.dtype, device=prod.device).index_add_(0, seg, prod)
    a = ata_flat[out[:, 2]]
    c = torch.where(out[:, 3, None, None, None] != 0, a.transpose(-1, -2), a) - acc
    j, r = out[:, 0], out[:, 1]
    c = torch.where((j == r)[:, None, None, None], 0.5 * (c + c.transpose(-1, -2)), c)
    dense = torch.zeros((bsz, K, d, K, d), dtype=c.dtype, device=c.device)
    # advanced indices split by a slice land in front: values (n_out, B, d, d)
    dense[:, r, :, j, :] = c
    dense[:, j, :, r, :] = c.transpose(-1, -2)
    return dense.reshape(bsz, K * d, K * d)


# ---------------------------------------------------------------------------
# dispatching wrappers
# ---------------------------------------------------------------------------
def _entry(name, arrays, d):
    """The kernel's entry point for the arrays' dtype, after the checks:
    one device and dtype, contiguous (the kernels index them and write them
    in place), blocks of d <= SMALL_DIM_MAX, a batch B and block d in all."""
    dev, dt, bsz = arrays[0].device, arrays[0].dtype, arrays[0].shape[1]
    for a in arrays:
        if a.device != dev or a.dtype != dt:
            raise ValueError(f"{name}: operands must share device and dtype")
        if not a.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (read and written in place)")
        if a.dim() < 3 or a.shape[1] != bsz or a.shape[-1] != d:
            raise ValueError(f"{name}: operand of shape {tuple(a.shape)} is not (rows, {bsz}, ..., {d})")
    if d > SMALL_DIM_MAX:
        raise ValueError(f"{name}: the CUDA kernel takes blocks of d <= {SMALL_DIM_MAX}, got {d}")
    return getattr(_cuda.lib(), f"th_{name}_{_cuda.suffix(dt)}")


def _launch_levels(name, levels, arrays, rows, geometry):
    """One launch of `name`'s kernel a level, the levels in order: (the
    arrays' pointers, the level's record, C, rl, ul, B, d, *geometry(C, rl,
    ul), stream). rows: the rows of AtA, the factor and a vector the stage
    reads (inf for one it does not), past which no level's tables may
    reach; every record must be on the arrays' device."""
    dev, B, d = arrays[0].device, arrays[0].shape[1], arrays[0].shape[-1]
    fn = _entry(name, arrays, d)
    ptrs, st = [a.data_ptr() for a in arrays], _cuda.stream_of(arrays[0])
    n_a, n_l, n_v = rows
    with torch.cuda.device(dev):
        for t in levels:
            a, l, v = t["need"]
            rec = t["rec"]
            if a > n_a or l > n_l or v > n_v or rec.device != dev:
                raise ValueError(f"{name}: a level's tables on {rec.device} reach rows {a - 1}, {l - 1}, "
                                 f"{v - 1} of AtA, the factor and the vectors: arrays of {rows} rows on {dev}")
            C, rl, ul = t["dims"]
            _cuda.check(fn(*ptrs, rec.data_ptr(), C, rl, ul, B, d, *geometry(C, rl, ul), st), name)
            _cuda.launches[name] += 1


def level_factor(levels: Sequence[dict], ata_flat, lflat):
    """Eliminates each level of `levels` in order into the factor lflat
    (nnz_l + 1, B, d, d), in place, from ata_flat (n_slots, B, d, d): one
    `level_factor_kernel` launch a level (`level_factor_plain` on the
    CPU). The padded rows write nothing: slot 0 stays the zero block."""
    if not use_kernel(lflat):
        return level_factor_plain(levels, ata_flat, lflat)
    _launch_levels("level_factor", levels, (ata_flat, lflat), (ata_flat.shape[0], lflat.shape[0], math.inf),
                   lambda C, rl, ul: ())


def update_lanes(ul: int) -> int:
    """Lanes that share one output's update list of ul updates: the power
    of two at or above ul, up to a warp. The whole forward sweep
    (sparse/whole.py) takes the same per level, so both sum in one order."""
    gu = 1
    while gu < min(ul, WARP):
        gu *= 2
    return gu


@functools.lru_cache(maxsize=4096)
def fwd_subst_geometry(C: int, ul: int, B: int, d: int, itemsize: int, min_blocks: int):
    """(bt, gu, uc) of one `level_fwd_subst` launch (csrc/level_subst.cu):
    a block per (column, tile of bt batch elements), gu lanes per output
    (batch element, row) sharing its update list, the list staged uc
    updates at a time (uc = ul, or a multiple of gu).

    gu is `update_lanes(ul)`. bt starts at
    FWD_TILE_MAX and halves while a block would exceed FWD_THREADS_MAX
    threads or the launch would have fewer than min_blocks blocks
    (FWD_BLOCKS_PER_SM times the card's SMs: 264 on the H100), or
    one staged chunk of gu updates would exceed FWD_SMEM_MAX; then bt <= B."""
    gu = update_lanes(ul)
    per_u = (d * d + d) * itemsize  # one (ljk, yk) block pair, or (ldiag, b)

    def smem(bt, uc):
        return (uc + 1) * bt * per_u

    bt = FWD_TILE_MAX
    while bt > 1 and (bt * d * gu > FWD_THREADS_MAX or C * -(-B // bt) < min_blocks
                      or smem(bt, min(max(ul, 1), gu)) > FWD_SMEM_MAX):
        bt //= 2
    bt = max(1, min(bt, B))
    uc = max(ul, 1)
    if smem(bt, uc) > FWD_SMEM_MAX:
        uc = max(gu, (FWD_SMEM_MAX // (bt * per_u) - 1) // gu * gu)
    return bt, gu, uc


def bwd_subst_smem(bt: int, rc: int, d: int, itemsize: int) -> int:
    """Shared-memory bytes of one `level_bwd_subst` block (csrc/level_subst.cu
    bwd_smem_bytes): rc staged rows and the diagonal row, each a slot of bt
    d x d blocks and one of bt d-vectors, every slot a multiple of 16 bytes."""
    v = 16 // itemsize

    def slot(n):
        return -(-n // v) * v

    return (rc + 1) * (slot(bt * d * d) + slot(bt * d)) * itemsize


@functools.lru_cache(maxsize=4096)
def bwd_subst_geometry(C: int, rl: int, B: int, d: int, itemsize: int, min_blocks: int):
    """(bt, rc) of one `level_bwd_subst` launch (csrc/level_subst.cu): a
    block per (column, tile of bt batch elements), d lanes per batch
    element, the column's rows 1 .. rl - 1 staged rc at a time in order.

    The forward's rule: bt starts at FWD_TILE_MAX and halves while a block
    would exceed FWD_THREADS_MAX threads or the launch would have fewer
    than min_blocks blocks (FWD_BLOCKS_PER_SM times the card's SMs: 264 on
    the H100), or one staged row would exceed FWD_SMEM_MAX; then bt <= B.
    rc is `bwd_subst_rows(bt, ...)`."""
    bt = FWD_TILE_MAX
    while bt > 1 and (bt * d > FWD_THREADS_MAX or C * -(-B // bt) < min_blocks
                      or bwd_subst_smem(bt, 1, d, itemsize) > FWD_SMEM_MAX):
        bt //= 2
    bt = max(1, min(bt, B))
    return bt, bwd_subst_rows(bt, rl, d, itemsize)


def bwd_subst_rows(bt: int, rl: int, d: int, itemsize: int) -> int:
    """Rows a staged chunk holds at a tile of bt: all rl - 1 (at least 1),
    or as many as FWD_SMEM_MAX holds."""
    rc = max(rl - 1, 1)
    if bwd_subst_smem(bt, rc, d, itemsize) > FWD_SMEM_MAX:
        rc = FWD_SMEM_MAX // bwd_subst_smem(bt, 0, d, itemsize) - 1
    return rc


def _min_blocks(t) -> int:
    """The substitution kernels' floor of blocks on t's card."""
    return FWD_BLOCKS_PER_SM * _cuda.sm_count(t.device.index)


def level_fwd_subst(levels: Sequence[dict], lflat, y, b):
    """Solves L y = b for the rows of each level's columns, the levels in
    order, into y (n, B, d) in place: one `fwd_subst_kernel` launch a level
    (`level_fwd_subst_plain` on the CPU). y's rows of the columns the
    levels update from hold their values already."""
    if not use_kernel(lflat):
        return level_fwd_subst_plain(levels, lflat, y, b)
    B, d, isz, mb = lflat.shape[1], lflat.shape[-1], lflat.element_size(), _min_blocks(lflat)
    _launch_levels("level_fwd_subst", levels, (lflat, y, b), (math.inf, lflat.shape[0], min(len(y), len(b))),
                   lambda C, rl, ul: fwd_subst_geometry(C, ul, B, d, isz, mb))


def level_bwd_subst(levels: Sequence[dict], lflat, x, y):
    """Solves L^T x = y for the rows of each level's columns, the levels in
    the order given (the elimination's reverse), into x (n, B, d) in place:
    one `bwd_subst_kernel` launch a level (`level_bwd_subst_plain` on the
    CPU). x's rows under each column's diagonal hold their values already."""
    if not use_kernel(lflat):
        return level_bwd_subst_plain(levels, lflat, x, y)
    B, d, isz, mb = lflat.shape[1], lflat.shape[-1], lflat.element_size(), _min_blocks(lflat)
    _launch_levels("level_bwd_subst", levels, (lflat, x, y), (math.inf, lflat.shape[0], min(len(x), len(y))),
                   lambda C, rl, ul: bwd_subst_geometry(C, rl, B, d, isz, mb))


def tail_update(sched, ata_flat, lflat):
    """The dense tail's matrix before its POTRF (`tail_update_plain`):
    ata_flat (n_slots, B, d, d), lflat (nnz_l + 1, B, d, d) with the head's
    columns factored -> (B, K d, K d)."""
    t = sched.tail_on(ata_flat.device)
    if not use_kernel(ata_flat):
        return tail_update_plain(t, ata_flat, lflat)
    K, B, d = sched.tail_k, ata_flat.shape[1], ata_flat.shape[-1]
    if ata_flat.shape != (sched.pattern.n_slots, B, d, d) or lflat.shape != (sched.sym.nnz_l + 1, B, d, d):
        raise ValueError(f"tail_update: shapes {ata_flat.shape}, {lflat.shape} do not fit the schedule")
    ata_flat, lflat = ata_flat.contiguous(), lflat.contiguous()  # read only
    fn = _entry("tail_update", [ata_flat, lflat], d)
    out = torch.empty((B, K * d, K * d), dtype=ata_flat.dtype, device=ata_flat.device)
    with torch.cuda.device(ata_flat.device):
        rc = fn(ata_flat.data_ptr(), lflat.data_ptr(), t["out"].data_ptr(), t["pair_ptr"].data_ptr(),
                t["pairs"].data_ptr(), t["out"].shape[0], K, B, d, out.data_ptr(), _cuda.stream_of(ata_flat))
    _cuda.check(rc, "tail_update")
    _cuda.launches["tail_update"] += 1
    return out


# ---------------------------------------------------------------------------
# one level stage on given operands: the checks of a kernel against its twin
# ---------------------------------------------------------------------------
class LevelStage(NamedTuple):
    """One stage of one level, `kind` "factor", "fwd" or "bwd":
    `fn([t], *arrays)` (a level kernel's entry point or its twin) writes
    arrays[1] in place; `out` indexes the rows it writes, (C, rl) factor
    slots or (C,) vector rows."""

    kind: str
    t: dict
    arrays: tuple
    out: torch.Tensor

    @property
    def dims(self):
        """(C, rl, ul) of the level."""
        return self.t["dims"]

    def run(self, fn):
        """fn on a copy of the written array: the rows it wrote,
        (C, rl, B, d, d) or (C, B, d); the padded rows read the zero slot."""
        arrays = list(self.arrays)
        arrays[1] = arrays[1].clone()
        fn([self.t], *arrays)
        return arrays[1][self.out]

    def launch(self, fn):
        """fn in place, for timings: the rows it writes are its own."""
        fn([self.t], *self.arrays)

    def operands(self):
        """The operands the stage reads, gathered as its twin gathers them:
        (col_a, ks, kj), (ljk, yk, b, ldiag) or (lcol, xr, y); col_a, b and
        y have the shape of the stage's output."""
        gather = {"factor": factor_operands, "fwd": fwd_operands, "bwd": bwd_operands}[self.kind]
        return gather(self.t, *self.arrays)


def level_stages(t: dict, ata_flat, lflat, y, x, b):
    """The factor, forward and backward stages of a schedule's level t
    (`NumericSchedule.on`) on a factorization's arrays and solve: (ata_flat,
    lflat), (lflat, y, b), (lflat, x, y)."""
    return (LevelStage("factor", t, (ata_flat, lflat), t["col_slots"]),
            LevelStage("fwd", t, (lflat, y, b), t["cols"]),
            LevelStage("bwd", t, (lflat, x, y), t["cols"]))


def _stacked_table(C: int, rl: int, ul: int, **fields) -> dict:
    """A level table of C columns, every row and update valid, the given
    tables and zeros elsewhere."""
    t = {k: np.zeros(s, dtype=np.int32) for k, s in (
        ("cols", C), ("diag_slots", C), ("a_src", (C, rl)), ("col_slots", (C, rl)), ("row_ids", (C, rl)),
        ("jk_slots", (C, ul)), ("upd_k", (C, ul)), ("upd_slots", (C, ul, rl)))}
    t.update(a_tr=np.zeros((C, rl), dtype=bool), valid=np.ones((C, rl), dtype=bool),
             row_valid=np.ones((C, rl), dtype=bool), upd_valid=np.ones((C, ul), dtype=bool))
    t.update({k: np.asarray(v, dtype=np.int32) for k, v in fields.items()})
    return t


def _behind_zero(*parts):
    """The parts' rows one after another behind a zero row."""
    zero = torch.zeros((1,) + parts[0].shape[1:], dtype=parts[0].dtype, device=parts[0].device)
    return torch.cat([zero] + [p.contiguous() for p in parts])


def factor_stage(col_a, ks, kj) -> LevelStage:
    """The factor stage on operands col_a (C, rl, B, d, d), ks (C, ul, rl,
    B, d, d), kj (C, ul, B, d, d): AtA holds col_a and the factor ks, kj and
    the output's slots, each behind the zero slot."""
    C, ul, rl = ks.shape[:3]
    n_ks, n_kj = C * ul * rl, C * ul
    ar = np.arange
    t = _stacked_table(C, rl, ul, a_src=1 + ar(C * rl).reshape(C, rl),
                       upd_slots=1 + ar(n_ks).reshape(C, ul, rl), jk_slots=1 + n_ks + ar(n_kj).reshape(C, ul),
                       col_slots=1 + n_ks + n_kj + ar(C * rl).reshape(C, rl))
    t["diag_slots"] = t["col_slots"][:, 0]
    bd = col_a.shape[2:]
    ata = _behind_zero(col_a.reshape((-1,) + bd))
    lflat = _behind_zero(ks.reshape((-1,) + bd), kj.reshape((-1,) + bd), torch.zeros_like(col_a).reshape((-1,) + bd))
    t = level_on(t, col_a.device)
    return LevelStage("factor", t, (ata, lflat), t["col_slots"])


def fwd_stage(ljk, yk, b, ldiag) -> LevelStage:
    """The forward stage on operands ljk (C, ul, B, d, d), yk (C, ul, B, d),
    b (C, B, d), ldiag (C, B, d, d): the factor holds ljk and ldiag behind
    the zero slot, y holds yk and then the output's rows."""
    C, ul = ljk.shape[:2]
    n = C * ul
    ar = np.arange
    t = _stacked_table(C, 1, ul, cols=n + ar(C), jk_slots=1 + ar(n).reshape(C, ul),
                       upd_k=ar(n).reshape(C, ul), diag_slots=1 + n + ar(C))
    vd = yk.shape[2:]
    lflat = _behind_zero(ljk.reshape((-1,) + ljk.shape[2:]), ldiag)
    y = torch.cat([yk.reshape((-1,) + vd), torch.zeros_like(b)])
    bb = torch.cat([torch.zeros_like(y[:n]), b])
    t = level_on(t, ljk.device)
    return LevelStage("fwd", t, (lflat, y, bb), t["cols"])


def bwd_stage(lcol, xr, y) -> LevelStage:
    """The backward stage on operands lcol (C, rl, B, d, d) (row 0 the
    diagonal block), xr (C, rl, B, d) (row 0 unread), y (C, B, d): the
    factor holds lcol behind the zero slot, x holds xr and then the output's
    rows."""
    C, rl = lcol.shape[:2]
    n = C * rl
    ar = np.arange
    t = _stacked_table(C, rl, 1, cols=n + ar(C), col_slots=1 + ar(n).reshape(C, rl),
                       row_ids=ar(n).reshape(C, rl))
    t["diag_slots"] = t["col_slots"][:, 0]
    vd = xr.shape[2:]
    lflat = _behind_zero(lcol.reshape((-1,) + lcol.shape[2:]))
    x = torch.cat([xr.reshape((-1,) + vd), torch.zeros_like(y)])
    yy = torch.cat([torch.zeros_like(x[:n]), y])
    t = level_on(t, lcol.device)
    return LevelStage("bwd", t, (lflat, x, yy), t["cols"])
