"""The whole backward sweep's stages, records and summation order, on the CPU.

`csrc/whole_subst.cu`'s backward kernel walks one batch element per block
through stages (`sparse/whole.py` `bwd_stages`, `bwd_records`, `BwdPlan`):
runs of columns of one etree level, the levels last to first, or pieces of
a column's rows too long for a stage buffer, each staged into shared
memory. d lanes per column (lane jj owns output jj) run s = y_j[jj], then
s -= L[t][i][jj] x_r[i] over the column's rows t = 1, 2, ... in order, i
inner, and one thread per column solves L_jj^T x_j = s. The kernel runs
only on the card (tests/test_torch_cuda.py); here:

- the records hold each (column, row) block once, in the column's row
  order, and each column's diagonal block last; x rows in the original
  order, y rows in the elimination order; the levels last to first;
- the plan's shared memory and x's place at PGO 256 x 128 and 2048 x 8,
  float32 and float64, with x in shared memory and, under a smaller
  budget, in device memory;
- a numpy model of the kernel's walk over the records gives the numpy
  model of the level backward sweep (level_subst.cu's backward kernel per
  level, on the operands `bwd_operands` gathers) bit for bit in float64,
  on chains, the 9-pose clique and with columns cut into pieces, and the
  plain twin `_bwd_scan` to 1e-12;
- at 16 x 4 the model's solve equals the JAX package's whole-sweep kernels
  (`pallas_whole.solve_whole`, interpret mode) to 1e-12.
"""

import re

import numpy as np
import pytest
import torch

from test_torch_whole_fwd_records import _builder, _system
from test_torch_whole_records import _pgo
from theseus_tpu_torch import _cuda
from theseus_tpu_torch.sparse import whole
from theseus_tpu_torch.sparse.cholesky import Factor, _bwd_scan, forward_sweep
from theseus_tpu_torch.sparse.level_kernels import bwd_operands
from theseus_tpu_torch.sparse.whole import (
    WHOLE_SUBST_RECORD_BUFS,
    bwd_records,
    bwd_stages,
    get_tables,
)


def _parse(tables, stages):
    """Per stage: (first, last, out, vrow, nu, boff, slot, kk) from the
    records the kernel reads."""
    rec, table, stage_ints = bwd_records(tables, stages)
    out = []
    for off, nc, nb, meta in table:
        r = rec[off: off + 4 * nc + 2 * nb]
        assert len(r) <= stage_ints
        assert meta & 63 == 1  # one lane an output
        o, vrow, nu, boff = (r[i * nc: (i + 1) * nc] for i in range(4))
        slot, kk = r[4 * nc: 4 * nc + nb], r[4 * nc + nb:]
        out.append((bool(meta & 64), bool(meta & 128), o, vrow, nu, boff, slot, kk))
    return out


# (poses, clique, stage buffer bytes in float64): whole levels; levels cut
# into runs; the 9-pose clique's columns of up to 10 rows cut into pieces;
# a 40-pose clique (dense tail off) with columns of up to 41 rows, cut
CASES = [(48, 0, 1 << 20), (48, 0, 2000), (48, 9, 5 * 288 + 48), (64, 40, 10 * 288 + 48)]


@pytest.mark.parametrize("n,clique,data", CASES)
def test_records_hold_each_row_once(n, clique, data):
    sched = _builder(n, clique)[0].sched
    assert sched.tail_k == 0
    tb = get_tables(sched)
    h = tb.host
    stages = bwd_stages(h, tb.levels, 6, 8, data)
    got = {j: ([], []) for j in range(tb.n)}
    diag = {}
    for first, last, out, vrow, nu, boff, slot, kk in _parse(h, stages):
        assert (boff == np.concatenate([[0], np.cumsum(nu + last)[:-1]])).all()
        assert len(slot) == int(nu.sum()) + last * len(out)
        assert first * len(out) * 6 * 8 + len(slot) * 288 <= max(data, 2 * 288 + 48)
        for ci, j in enumerate(vrow):
            assert out[ci] == h["perm"][j]
            assert bool(first) == (len(got[j][0]) == 0)
            us = slice(boff[ci], boff[ci] + nu[ci])
            got[j][0].extend(slot[us])
            got[j][1].extend(kk[us])
            if last:
                diag[j] = slot[boff[ci] + nu[ci]]
                assert kk[boff[ci] + nu[ci]] == 0
    for j in range(tb.n):
        rows = h["col_len"][j]
        np.testing.assert_array_equal(got[j][0], h["col_slots"][j, 1:rows])
        np.testing.assert_array_equal(got[j][1], h["perm"][h["row_ids"][j, 1:rows]])
        assert diag[j] == h["col_slots"][j, 0] == h["diag"][j]
    # the levels last to first
    level_of = np.empty(tb.n, np.int64)
    for lv, cols in enumerate(tb.levels):
        level_of[cols] = lv
    seen = [level_of[cols[0][0]] for _, _, _, cols in stages]
    assert seen == sorted(seen, reverse=True)
    if clique:
        assert any(not first or not last for _, first, last, _ in stages)


@pytest.mark.parametrize("n,itemsize,budget,x_smem", [
    (256, 4, None, True), (256, 8, None, True), (2048, 4, None, True), (2048, 8, None, True),
    (2048, 4, 32 * 1024, False), (2048, 8, 64 * 1024, False),
])
def test_plan_fits_the_budget(n, itemsize, budget, x_smem, monkeypatch):
    """x (n d values) sits in shared memory beside the buffers where it
    fits, else (a budget under it) in device memory; the bytes are the
    layout the launcher checks."""
    sched = _pgo(n)[0].sched
    if budget is not None:
        monkeypatch.setattr(whole, "WHOLE_SUBST_SMEM_MAX", budget)
        sched._whole_tables = None
    tb = get_tables(sched)
    plan = tb.bwd_plan(6, itemsize)
    assert tb.bwd_plan(6, itemsize) is plan
    assert plan.vec_smem == x_smem
    x = -(-tb.n * 6 * itemsize // 16) * 16 if x_smem else 0
    assert plan.buf_vals == max(nb * 36 + nc * 6 for _, nc, nb, _ in plan.table)
    buf = -(-plan.buf_vals * itemsize // 16) * 16
    assert plan.smem == x + 2 * buf + WHOLE_SUBST_RECORD_BUFS * 4 * plan.stage_ints <= whole.WHOLE_SUBST_SMEM_MAX
    threads = int(re.search(r"constexpr int WBS_THREADS = (\d+);", (_cuda.CSRC / "whole_subst.cu").read_text())[1])
    assert threads % 32 == 0 and threads >= 6
    assert plan.n_stages >= tb.n_levels


def whole_bwd_model(tables, stages, lflat, y):
    """The kernel's walk in numpy, vectorised over the batch and the d
    outputs of a column (each output's own chain of operations is the
    kernel's): per stage the buffer holds L[slot[k]]; s starts from the y
    row at a column's first piece and is kept across its pieces, each row
    block t in order, i inner; at its last piece the transposed diagonal
    solve. y (n, B, d) in the elimination order; returns x (n, B, d) in the
    original order."""
    d = lflat.shape[-1]
    x = np.zeros_like(y)
    carry = {}
    for first, last, out, vrow, nu, boff, slot, kk in _parse(tables, stages):
        buf = lflat[slot]
        for ci, j in enumerate(vrow):
            s = y[j].copy() if first else carry.pop(j)
            for t in range(nu[ci]):
                blk, v = buf[boff[ci] + t], x[kk[boff[ci] + t]]
                for i in range(d):
                    s = s - blk[:, i, :] * v[:, i, None]
            if not last:
                carry[j] = s
                continue
            l0 = buf[boff[ci] + nu[ci]]
            sol = np.zeros_like(s)
            for jj in range(d - 1, -1, -1):
                acc = s[:, jj]
                for k in range(jj + 1, d):
                    acc = acc - l0[:, k, jj] * sol[:, k]
                sol[:, jj] = acc / l0[:, jj, jj]
            x[out[ci]] = sol
    assert not carry
    return x


def level_bwd_model(lcol, xr, y):
    """level_subst.cu's backward kernel in numpy: per (column, batch
    element) s = y, then s -= L_r[i][j] x_r[i] over the rows r = 1 .. rl - 1
    (padded rows are zero blocks times zeroed x), i inner; then the
    transposed solve with row 0's diagonal block."""
    d = y.shape[-1]
    acc = y.copy()
    for r in range(1, lcol.shape[1]):
        for j in range(d):
            s = acc[..., j]
            for i in range(d):
                s = s - lcol[:, r, :, i, j] * xr[:, r, :, i]
            acc[..., j] = s
    l0 = lcol[:, 0]
    out = np.zeros_like(acc)
    for j in range(d - 1, -1, -1):
        s = acc[..., j]
        for k in range(j + 1, d):
            s = s - l0[..., k, j] * out[..., k]
        out[..., j] = s / l0[..., j, j]
    return out


def level_sweep_model(sched, lflat, y):
    """The level backward sweep (the levels last to first) with each level
    through `level_bwd_model`; x in the elimination order."""
    _, _, levels = sched.on(lflat.device)
    x = torch.zeros_like(y)
    for t in reversed(levels):
        lcol, xr, yy = bwd_operands(t, lflat, x, y)
        x[t["cols"]] = torch.as_tensor(level_bwd_model(lcol.numpy(), xr.numpy(), yy.numpy()))
    return x.numpy()


@pytest.mark.parametrize("n,clique,data", CASES)
def test_order_model_is_the_level_sweeps_bit_for_bit(n, clique, data):
    sched, lflat, atb = _system(n, 3, clique)
    tb = get_tables(sched)
    perm, _, _ = sched.on(atb.device)
    y = forward_sweep(sched, Factor(lflat), atb[perm])
    stages = bwd_stages(tb.host, tb.levels, 6, 8, data)
    got = whole_bwd_model(tb.host, stages, lflat.numpy(), y.numpy())
    want_elim = level_sweep_model(sched, lflat, y)
    np.testing.assert_array_equal(got[tb.host["perm"]], want_elim)
    twin = _bwd_scan(sched, lflat, y).numpy()
    np.testing.assert_allclose(got[tb.host["perm"]], twin, atol=1e-12 * np.abs(twin).max(), rtol=0)


def test_order_model_matches_jax_interpret_kernels():
    """At 16 x 4, on the JAX package's damped system and the port's factor
    of it: the port's forward twin, then the model of the backward kernel,
    against the JAX package's whole-sweep kernels in Pallas interpret mode
    (`pallas_whole.solve_whole`), 1e-12 relative to the largest entry."""
    from test_torch_whole import _rel_close
    from test_torch_whole import _system as jax_system
    from theseus_tpu.sparse import pallas_whole as pw

    jb, ata, atb, pb = jax_system(16, 4)
    lsoa = pw.factorize_whole(jb.sched, ata, interpret=True)
    xk = pw.solve_whole(jb.sched, lsoa, atb, interpret=True)
    sched = pb.sched
    factor = whole.whole_factor(sched, torch.as_tensor(np.array(ata)))
    y = whole.whole_fwd_subst(sched, factor, torch.as_tensor(np.array(atb)))
    tb = get_tables(sched)
    stages = tb.bwd_plan(6, 8).stages
    x = whole_bwd_model(tb.host, stages, factor.blocks.numpy(), y.numpy())
    _rel_close(x, xk, 1e-12)
