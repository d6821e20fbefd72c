"""The whole forward sweep's stages, records and summation order, on the CPU.

`csrc/whole_subst.cu`'s forward kernel walks one batch element per block
through stages (`sparse/whole.py` `fwd_stages`, `fwd_records`, `FwdPlan`):
runs of columns of one etree level, or pieces of a column's update list
too long for a stage buffer, each staged into shared memory. gu lanes per
output (column, row) sum the update list, lane g over u = g, g + gu, ...,
and a fixed shuffle tree adds them; gu is the level's `update_lanes`, the
level forward kernel's rule. The kernel runs only on the card
(tests/test_torch_cuda.py); here:

- the per-level gu equals `fwd_subst_geometry`'s at PGO 64 x 16,
  256 x 128 and 2048 x 8, and every stage carries its level's gu;
- the records hold every column's update list and diagonal once, in order;
- the plan's shared memory and y's place at the PGO shapes, and the
  kernel's block (`WFS_THREADS`) takes a piece's lanes in one pass;
- a numpy model of the kernel's walk over the records gives the numpy
  model of the level forward sweep (tests/test_torch_fwd_subst_tree.py)
  bit for bit, with whole columns and with lists cut into pieces, and the
  plain twin `_fwd_scan` to 1e-12 in float64.
"""

import re

import numpy as np
import pytest
import torch

from test_torch_fwd_subst_tree import H100_MIN_BLOCKS
from test_torch_fwd_subst_tree import model as level_model
from test_torch_whole_records import _pgo
from theseus_tpu_torch import _cuda, config
from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
from theseus_tpu_torch.sparse.cholesky import _fwd_scan, factorize_levels
from theseus_tpu_torch.sparse.level_kernels import fwd_operands, fwd_subst_geometry, update_lanes
from theseus_tpu_torch.sparse.whole import (
    WHOLE_SUBST_RECORD_BUFS,
    WHOLE_SUBST_SMEM_MAX,
    fwd_records,
    fwd_stages,
    get_tables,
)


@pytest.mark.parametrize("n,b", [(64, 16), (256, 128), (2048, 8)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_gu_per_level_is_the_level_kernels(n, b, itemsize):
    sched = _pgo(n)[0].sched
    tb = get_tables(sched)
    plan = tb.fwd_plan(6, itemsize)
    assert len(plan.gu) == len(sched.level_tables) == tb.n_levels
    for lv, t in enumerate(sched.level_tables):
        C, ul = t["jk_slots"].shape
        assert plan.gu[lv] == fwd_subst_geometry(C, ul, b, 6, itemsize, H100_MIN_BLOCKS)[1]
    # every stage carries its level's gu, and the stages walk the levels in order
    level_of = np.empty(tb.n, np.int64)
    for lv, cols in enumerate(tb.levels):
        level_of[cols] = lv
    seen = [level_of[cols[0][0]] for _, _, _, cols in plan.stages]
    assert seen == sorted(seen)
    for (gu, _, _, cols), lv in zip(plan.stages, seen):
        assert gu == plan.gu[lv] and all(level_of[j] == lv for j, _, _ in cols)


def _parse(tables, stages):
    """Per stage: (gu, first, last, col, brow, nu, boff, slot, kk) from the
    records the kernel reads."""
    rec, table, stage_ints = fwd_records(tables, stages)
    out = []
    for off, nc, nb, meta in table:
        r = rec[off: off + 4 * nc + 2 * nb]
        assert len(r) <= stage_ints
        col, brow, nu, boff = (r[i * nc: (i + 1) * nc] for i in range(4))
        slot, kk = r[4 * nc: 4 * nc + nb], r[4 * nc + nb:]
        out.append((meta & 63, bool(meta & 64), bool(meta & 128), col, brow, nu, boff, slot, kk))
    return out


# (poses, clique, stage buffer bytes in float64): whole levels; levels cut
# into runs; update lists cut into pieces of a multiple of gu. Pieces need a
# list longer than gu = 32: 40 poses joined all to all, with the dense tail
# off (with it, the clique would be the tail), give columns of up to 39
# updates; a buffer of 34 blocks holds a piece of 32.
CASES = [(48, 0, 1 << 20), (48, 0, 2000), (48, 9, 5 * 288 + 48), (64, 40, 34 * 288 + 48)]


def _builder(n, clique, b=1):
    if clique <= 16:
        return _pgo(n, b, clique)
    config.set_sparse_dense_tail(False)
    try:
        return _pgo(n, b, clique)
    finally:
        config.set_sparse_dense_tail(True)


@pytest.mark.parametrize("n,clique,data", CASES)
def test_records_hold_each_update_once(n, clique, data):
    sched = _builder(n, clique)[0].sched
    assert sched.tail_k == 0
    tb = get_tables(sched)
    h = tb.host
    stages = fwd_stages(h, tb.levels, 6, 8, data)
    got = {j: ([], []) for j in range(tb.n)}
    diag = {}
    for gu, first, last, col, brow, nu, boff, slot, kk in _parse(h, stages):
        assert (boff == np.concatenate([[0], np.cumsum(nu + last)[:-1]])).all()
        assert len(slot) == int(nu.sum()) + last * len(col)
        assert last * len(col) * 6 * 8 + len(slot) * 288 <= max(data, (gu + 1) * 288 + 48)
        for ci, j in enumerate(col):
            assert brow[ci] == h["perm"][j]
            us = slice(boff[ci], boff[ci] + nu[ci])
            if not first:
                assert len(got[j][0]) % gu == 0  # a piece starts on a multiple of gu
            got[j][0].extend(slot[us])
            got[j][1].extend(kk[us])
            if last:
                diag[j] = slot[boff[ci] + nu[ci]]
    for j in range(tb.n):
        u = h["ucount"][j]
        np.testing.assert_array_equal(got[j][0], h["upd_jk"][j, :u])
        np.testing.assert_array_equal(got[j][1], h["upd_k"][j, :u])
        assert diag[j] == h["diag"][j]
    if clique > 32:
        assert any(not first or not last for _, first, last, _ in stages)


@pytest.mark.parametrize("n,itemsize,y_smem", [(256, 4, True), (256, 8, True), (2048, 4, True),
                                                (2048, 8, True), (4400, 8, False)])
def test_plan_fits_the_budget(n, itemsize, y_smem):
    tb = get_tables(_pgo(n)[0].sched)
    plan = tb.fwd_plan(6, itemsize)
    assert plan.vec_smem == y_smem
    y = -(-tb.n * 6 * itemsize // 16) * 16 if y_smem else 0
    assert plan.buf_vals == max(nb * 36 + nc * 6 for _, nc, nb, _ in plan.table)
    buf = -(-plan.buf_vals * itemsize // 16) * 16
    assert plan.smem == y + 2 * buf + WHOLE_SUBST_RECORD_BUFS * 4 * plan.stage_ints <= WHOLE_SUBST_SMEM_MAX
    threads = int(re.search(r"constexpr int WFS_THREADS = (\d+);", (_cuda.CSRC / "whole_subst.cu").read_text())[1])
    assert threads % 32 == 0 and threads >= 6 * max(plan.gu)
    assert plan.n_stages >= tb.n_levels


def whole_model(tables, stages, lflat, b):
    """The kernel's walk in numpy, vectorised over the batch: per stage the
    buffer holds L[slot[k]]; gu lanes per output (column, row), lane g over
    u = g, g + gu, ... of the stage's part of the list, j inner, kept
    across a column's pieces; at its last piece the shuffle tree, then
    acc = b - sum and the diagonal solve. b (n, B, d) in the original
    order; returns y (n, B, d) in the elimination order."""
    n, d = tables["perm"].shape[0], lflat.shape[-1]
    y = np.zeros((n,) + b.shape[1:])
    lanes = {}
    for gu, first, last, col, brow, nu, boff, slot, kk in _parse(tables, stages):
        buf = lflat[slot]
        for ci, j in enumerate(col):
            if first:
                lanes[j] = np.zeros((gu,) + b.shape[1:])
            for g in range(gu):
                for u in range(g, nu[ci], gu):
                    blk, v = buf[boff[ci] + u], y[kk[boff[ci] + u]]
                    for jj in range(d):
                        lanes[j][g] = lanes[j][g] + blk[:, :, jj] * v[:, None, jj]
            if not last:
                continue
            part = lanes.pop(j)
            off = gu // 2
            while off:
                part[:off] = part[:off] + part[off: 2 * off]
                off //= 2
            acc = b[brow[ci]] - part[0]
            ld = buf[boff[ci] + nu[ci]]
            out = np.zeros_like(acc)
            for r in range(d):
                s = acc[:, r]
                for k in range(r):
                    s = s - ld[:, r, k] * out[:, k]
                out[:, r] = s / ld[:, r, r]
            y[j] = out
    return y


def _system(n, b, clique):
    bld, obj, init = _builder(n, clique, b)
    co = obj.compile()
    vals = obj.default_values(init)
    state, aux = co.pack(vals, b), co.build_aux(vals, b)
    with config.plain_path():
        ata, atb = assemble(bld.pattern, co.linearize_blocks(state, aux))
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    return bld.sched, factorize_levels(bld.sched, ata).blocks, atb


def level_sweep_model(sched, lflat, b_perm):
    """The level forward sweep with each level through the numpy model of
    level_subst.cu's forward kernel, at its geometry."""
    _, _, levels = sched.on(lflat.device)
    y = torch.zeros_like(b_perm)
    for t in levels:
        ljk, yk, bb, ldiag = fwd_operands(t, lflat, y, b_perm)
        C, ul, B, d, _ = ljk.shape
        geo = fwd_subst_geometry(C, ul, B, d, 8, H100_MIN_BLOCKS)
        y[t["cols"]] = torch.as_tensor(level_model(ljk.numpy(), yk.numpy(), bb.numpy(), ldiag.numpy(), *geo))
    return y.numpy()


@pytest.mark.parametrize("n,clique,data", CASES)
def test_order_model_is_the_level_sweeps_bit_for_bit(n, clique, data):
    sched, lflat, atb = _system(n, 3, clique)
    tb = get_tables(sched)
    perm, _, _ = sched.on(atb.device)
    stages = fwd_stages(tb.host, tb.levels, 6, 8, data)
    got = whole_model(tb.host, stages, lflat.numpy(), atb.numpy())
    np.testing.assert_array_equal(got, level_sweep_model(sched, lflat, atb[perm]))
    want = _fwd_scan(sched, lflat, atb[perm]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)


def test_update_lanes():
    assert [update_lanes(u) for u in (0, 1, 2, 3, 8, 9, 17, 32, 33, 400)] == [1, 1, 2, 4, 8, 16, 32, 32, 32, 32]
