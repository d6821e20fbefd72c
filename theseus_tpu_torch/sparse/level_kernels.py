"""Per-level factor and substitution, and the dense tail's external update: CUDA kernels and plain twins (JAX counterpart: theseus_tpu/sparse/pallas_factorize.py; the tail's update is jnp in sparse/cholesky.py).

Four entry points, each launching its kernel on a CUDA tensor and running
its plain twin on a CPU tensor:

- `level_factor(col_a, ks, kj)` -> newcol (`csrc/level_factor.cu`)
- `level_fwd_subst(ljk, yk, b, ldiag)` -> y (`csrc/level_subst.cu`)
- `level_bwd_subst(lcol, xr, y)` -> x (`csrc/level_subst.cu`)
- `tail_update(sched, ata_flat, lflat)` -> the dense trailing supernode's
  symmetric matrix before its POTRF (`csrc/tail_update.cu`)

The level operands are AoS with the batch before the block: (C, rows, B,
d, d) and (C, rows, B, d). The gathers that build them and the scatters of
the results stay in sparse/cholesky.py. The twins follow cholesky.py's
`_factorize_levels` / `_solve_levels` arithmetic through the unrolled
ops/batched_linalg routines. The substitution kernels' launch geometry is
chosen here (`fwd_subst_geometry`, `bwd_subst_geometry`), where the CPU
tests reach it. `tail_update` and its twin read the factor and AtA in
place through the schedule's lists (`NumericSchedule.tail_on`).
"""

from __future__ import annotations

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


def update_lanes(ul: int) -> int:
    """Lanes that share one output's update list of ul updates: the power
    of two at or above ul, up to a warp. The whole forward sweep
    (sparse/whole.py) takes the same per level, so both sum in one order."""
    gu = 1
    while gu < min(ul, WARP):
        gu *= 2
    return gu


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


def level_fwd_subst(ljk, yk, b, ldiag):
    if not use_kernel(ljk):
        return level_fwd_subst_plain(ljk, yk, b, ldiag)
    C, ul, B, d, _ = ljk.shape
    if yk.shape != (C, ul, B, d) or b.shape != (C, B, d) or ldiag.shape != (C, B, d, d):
        raise ValueError(f"level_fwd_subst: shapes {ljk.shape}, {yk.shape}, {b.shape}, {ldiag.shape} do not agree")
    fn, (ljk, yk, b, ldiag) = _prepare("level_fwd_subst", [ljk, yk, b, ldiag], d)
    sms = _cuda.sm_count(ljk.device.index)
    bt, gu, uc = fwd_subst_geometry(C, ul, B, d, ljk.element_size(), FWD_BLOCKS_PER_SM * sms)
    y = torch.empty_like(b)
    with torch.cuda.device(ljk.device):
        rc = fn(ljk.data_ptr(), yk.data_ptr(), b.data_ptr(), ldiag.data_ptr(), C, ul, B, d,
                bt, gu, uc, y.data_ptr(), _cuda.stream_of(ljk))
    _cuda.check(rc, "level_fwd_subst")
    _cuda.launches["level_fwd_subst"] += 1
    return y


def level_bwd_subst(lcol, xr, y):
    if not use_kernel(lcol):
        return level_bwd_subst_plain(lcol, xr, y)
    C, rl, B, d, _ = lcol.shape
    if xr.shape != (C, rl, B, d) or y.shape != (C, B, d):
        raise ValueError(f"level_bwd_subst: shapes {lcol.shape}, {xr.shape}, {y.shape} do not agree")
    fn, (lcol, xr, y) = _prepare("level_bwd_subst", [lcol, xr, y], d)
    sms = _cuda.sm_count(lcol.device.index)
    bt, rows = bwd_subst_geometry(C, rl, B, d, lcol.element_size(), FWD_BLOCKS_PER_SM * sms)
    x = torch.empty_like(y)
    with torch.cuda.device(lcol.device):
        rc = fn(lcol.data_ptr(), xr.data_ptr(), y.data_ptr(), C, rl, B, d, bt, rows,
                x.data_ptr(), _cuda.stream_of(lcol))
    _cuda.check(rc, "level_bwd_subst")
    _cuda.launches["level_bwd_subst"] += 1
    return x


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
    fn, (ata_flat, lflat) = _prepare("tail_update", [ata_flat, lflat], d)
    out = torch.empty((B, K * d, K * d), dtype=ata_flat.dtype, device=ata_flat.device)
    with torch.cuda.device(ata_flat.device):
        rc = fn(ata_flat.data_ptr(), lflat.data_ptr(), t["out"].data_ptr(), t["pair_ptr"].data_ptr(),
                t["pairs"].data_ptr(), t["out"].shape[0], K, B, d, out.data_ptr(), _cuda.stream_of(ata_flat))
    _cuda.check(rc, "tail_update")
    _cuda.launches["tail_update"] += 1
    return out
