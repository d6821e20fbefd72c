"""The whole factor kernel's index records, shared-memory budget and order, on the CPU.

`csrc/whole_factor.cu` walks the etree levels of one batch element per
block from per-level index records (`sparse/whole.py` `factor_records`),
and keeps the block's factor in shared memory when it, the level table and
three record buffers fit WHOLE_FACTOR_SMEM_MAX. The kernel runs only on the card
(tests/test_torch_cuda.py); here:

- the records hold exactly the per-column tables' valid rows and updates;
- `whole_factor_smem_bytes` and the variant it selects at the PGO shapes:
  shared memory at 40 and 256 poses in float32 and float64, device memory
  at 2048 and 4400 poses;
- a numpy model of the kernel's walk over the records (A copied into the
  factor slots, phase 1 in place, the POTRF's statements, the TRSM)
  matches the plain twin `_factorize_scan` to 1e-12 in float64, on the
  chain graph and on one with a column longer than a warp's TRSM lanes.
"""

import numpy as np
import pytest
import torch

from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
from theseus_tpu_torch.sparse.cholesky import _factorize_scan
from theseus_tpu_torch.sparse.whole import (
    WHOLE_FACTOR_SMEM_MAX,
    WHOLE_FACTOR_STAGES,
    get_tables,
    whole_factor_smem_bytes,
    whole_factor_variant,
)
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

_CACHE = {}


def _pgo(n, b=1, clique=0):
    """(builder, objective, initial values) of the PGO problem at n poses;
    clique > 0 also joins `clique` poses spread along the chain all to all,
    so the first of them eliminated has a column of at least `clique` rows."""
    if (n, b, clique) not in _CACHE:
        gt, edges, meas, init = synthetic_pose_graph(n, b, seed=0, dtype=torch.float64, device="cpu")
        if clique:
            hub = list(range(0, n, n // clique))[:clique]
            extra = [(i, j) for i in hub for j in hub if i < j and (i, j) not in set(map(tuple, edges))]
            e = torch.as_tensor(extra)
            meas = torch.cat([meas, se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])])
            edges = list(edges) + extra
        obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=torch.float64, device="cpu")
        _CACHE[(n, b, clique)] = (SparseNormalBuilder(obj.compile()), obj, pose_values(init))
    return _CACHE[(n, b, clique)]


def _records(sched):
    """Per level: (nc, rl, ul, dict of the record's arrays)."""
    t = get_tables(sched)
    rec, lvl = t.host["fact_rec"], t.host["fact_lvl"]
    out = []
    for off, nc, rl, ul in lvl:
        r, parts = rec[off:], {}
        for name, size, shape in (("len", nc, (nc,)), ("uc", nc, (nc,)), ("cs", nc * rl, (nc, rl)),
                                  ("ac", nc * rl, (nc, rl)), ("jk", nc * ul, (nc, ul)),
                                  ("us", nc * ul * rl, (nc, ul, rl))):
            parts[name], r = r[:size].reshape(shape), r[size:]
        out.append((nc, rl, ul, parts))
    return out


@pytest.mark.parametrize("n,clique", [(40, 0), (256, 0), (48, 9)])
def test_records_hold_the_column_tables(n, clique):
    sched = _pgo(n, clique=clique)[0].sched
    t = get_tables(sched)
    recs = _records(sched)
    assert len(recs) == t.n_levels
    lvl = t.host["fact_lvl"]
    sizes = [nc * (2 + 2 * rl + ul + ul * rl) for _, nc, rl, ul in lvl]
    assert lvl[0, 0] == 0 and (np.diff(lvl[:, 0]) == sizes[:-1]).all()
    assert len(t.host["fact_rec"]) == sum(sizes) and t.stage_ints == max(sizes)
    for lv, (nc, rl, ul, r) in enumerate(recs):
        cols = t.levels[lv]
        assert nc == len(cols)
        np.testing.assert_array_equal(r["len"], sched.row_valid[cols].sum(axis=1))
        np.testing.assert_array_equal(r["uc"], sched.upd_valid[cols].sum(axis=1))
        assert rl == r["len"].max() and ul == r["uc"].max()
        for ci, j in enumerate(cols):
            nr, nu = r["len"][ci], r["uc"][ci]
            np.testing.assert_array_equal(r["cs"][ci, :nr], sched.col_slots[j, :nr])
            np.testing.assert_array_equal(r["ac"][ci, :nr] >> 1, sched.a_src[j, :nr])
            np.testing.assert_array_equal(r["ac"][ci, :nr] & 1, sched.a_tr[j, :nr])
            np.testing.assert_array_equal(r["jk"][ci, :nu], sched.upd_jk_slots[j, :nu])
            np.testing.assert_array_equal(r["us"][ci, :nu, :nr], sched.upd_slots[j, :nu, :nr])


# (poses, bytes in float32, float64): the factor (nnz_l + 1) d^2 values,
# rounded up to 16 bytes, the level table (16 bytes a level) and three
# buffers of the largest record
@pytest.mark.parametrize("n,f32,f64,variant", [
    (40, 16992 + 8 * 16 + 3 * 112 * 4, 33984 + 8 * 16 + 3 * 112 * 4, "shared"),
    (256, 110304 + 13 * 16 + 3 * 640 * 4, 220608 + 13 * 16 + 3 * 640 * 4, "shared"),
    (2048, 884448 + 16 * 16 + 3 * 5120 * 4, 1768896 + 16 * 16 + 3 * 5120 * 4, "device"),
    (4400, 1900512 + 18 * 16 + 3 * 11264 * 4, 3801024 + 18 * 16 + 3 * 11264 * 4, "device"),
])
def test_smem_bytes_and_variant(n, f32, f64, variant):
    sched = _pgo(n)[0].sched
    assert WHOLE_FACTOR_STAGES == 3
    for itemsize, want in ((4, f32), (8, f64)):
        assert whole_factor_smem_bytes(sched, 6, itemsize) == want
        assert whole_factor_variant(sched, 6, itemsize) == variant
        assert (want <= WHOLE_FACTOR_SMEM_MAX) == (variant == "shared")


def test_clique_has_a_column_beyond_a_warp():
    """Nine poses joined all to all: a level's rl rows give (rl - 1) d TRSM
    items, more than the 32 lanes the kernel's phase 2 runs at once."""
    lvl = get_tables(_pgo(48, clique=9)[0].sched).host["fact_lvl"]
    assert (int(lvl[:, 2].max()) - 1) * 6 > 32
    assert (int(get_tables(_pgo(48)[0].sched).host["fact_lvl"][:, 2].max()) - 1) * 6 <= 32


def model(sched, ata):
    """The kernel's walk in numpy, vectorised over the batch: per level,
    A copied into the factor slots (read transposed where a_tr), phase 1 in
    place, u outer and k inner from zero; the POTRF's statements (pivot,
    its reciprocal, the column by products); the TRSM row by row."""
    d = ata.shape[-1]
    f = np.zeros((sched.sym.nnz_l + 1,) + ata.shape[1:])
    for nc, rl, ul, r in _records(sched):
        for ci in range(nc):  # the AtA prefetch into the slots
            for t in range(r["len"][ci]):
                a = ata[r["ac"][ci, t] >> 1]
                f[r["cs"][ci, t]] = np.swapaxes(a, -1, -2) if r["ac"][ci, t] & 1 else a
        for ci in range(nc):  # phase 1
            for t in range(r["len"][ci]):
                s = np.zeros(ata.shape[1:])
                for u in range(r["uc"][ci]):
                    kr, kj = f[r["us"][ci, u, t]], f[r["jk"][ci, u]]
                    for k in range(d):
                        s = s + kr[:, :, None, k] * kj[:, None, :, k]
                f[r["cs"][ci, t]] = f[r["cs"][ci, t]] - s
        for ci in range(nc):  # phase 2: POTRF, then TRSM
            c = f[r["cs"][ci, 0]].copy()
            lrow = np.zeros_like(c)  # lrow[:, r] is lane r's row
            for jj in range(d):
                s = c[:, jj, jj]
                for k in range(jj):
                    s = s - lrow[:, jj, k] * lrow[:, jj, k]
                piv = np.sqrt(s)
                inv = 1.0 / piv
                lrow[:, jj, jj] = piv
                for row in range(jj + 1, d):
                    t_ = 0.5 * (c[:, row, jj] + c[:, jj, row])
                    for k in range(jj):
                        t_ = t_ - lrow[:, row, k] * lrow[:, jj, k]
                    lrow[:, row, jj] = t_ * inv
            f[r["cs"][ci, 0]] = lrow
            for t in range(1, r["len"][ci]):
                row, x = f[r["cs"][ci, t]], np.zeros_like(lrow)
                for jj in range(d):
                    s = row[:, :, jj].copy()
                    for k in range(jj):
                        s = s - x[:, :, k] * lrow[:, None, jj, k]
                    x[:, :, jj] = s / lrow[:, None, jj, jj]
                f[r["cs"][ci, t]] = x
    return f


@pytest.mark.parametrize("clique", [0, 9])
def test_order_model_matches_twin(clique):
    bld, obj, init = _pgo(48, 4, clique)
    co = obj.compile()
    vals = obj.default_values(init)
    state, aux = co.pack(vals, 4), co.build_aux(vals, 4)
    with config.plain_path():
        ata, _ = assemble(bld.pattern, co.linearize_blocks(state, aux))
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    got = model(bld.sched, ata.numpy())
    want = _factorize_scan(bld.sched, ata).numpy()
    assert not got[0].any()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
