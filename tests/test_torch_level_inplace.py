"""The level plan's in-place entry points against the gathered-operand plan, on the CPU.

`level_factor`, `level_fwd_subst` and `level_bwd_subst` read AtA, the
factor and the vectors in place through each level's tables and write
their columns in place (sparse/level_kernels.py). The reference here, the
gathered-operand plan, gathers each level's operands, runs the operand-form
arithmetic, masks the padded rows and scatters the result. On PGO problems
whose levels are
ragged (a 6 x 6 and an 8 x 8 grid and a 16-pose clique, with a dense tail;
chains of 16 and 64 poses), float32 and float64:

- `factorize_levels` and `solve_levels` give the gathered-operand plan's
  factor, y and x bit for bit (`torch.equal`);
- slot 0 of the factor stays the zero block;
- a padded update or row reads as zero: a NaN in b's row 0 (so in y's row
  0) reaches exactly the columns that update from column 0, and a NaN in
  x's row 0 before the backward sweep (no column reads it: every row under
  a diagonal comes later) reaches none;
- each level's tables reach no row past the arrays, and the record holds
  the valid rows and updates as prefixes.

The kernels run on the card (tests/test_torch_cuda.py); here the CPU
tensors run their plain twins through the same entry points.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_tail import clique_edges, grid_edges
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.ops.batched_linalg import chol_small, rt_solve_lower, solve_lower_vec, solve_upper_vec
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse import assemble as pasm
from theseus_tpu_torch.sparse.cholesky import (
    Factor,
    _tail_bwd_solve,
    _tail_dense_eliminate,
    _tail_fwd_solve,
    backward_sweep,
    factorize_levels,
    forward_sweep,
    solve_levels,
)
from theseus_tpu_torch.sparse.level_kernels import (
    bwd_operands,
    factor_operands,
    fwd_operands,
    level_bwd_subst,
    level_fwd_subst,
    level_record,
)
from theseus_tpu_torch.utils.convert import problem_from_arrays
from theseus_tpu_torch.utils.examples.pose_graph import chain_edges

GRAPHS = {
    "grid6": (36, grid_edges(6, 6)),
    "grid8": (64, grid_edges(8, 8)),
    "clique16": (16, clique_edges(16)),
    "chain16": (16, chain_edges(16, True)),
    "chain64": (64, chain_edges(64, True)),
}
DTYPES = [torch.float32, torch.float64]


@functools.lru_cache(maxsize=None)
def _system(name, dtype, b=3, seed=0):
    """(schedule, LM-damped ata, atb) of a PGO problem on the graph, from a
    numpy Generator."""
    n, edges = GRAPHS[name]
    rng = np.random.default_rng(seed)
    normal = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    gt = se3.exp(0.5 * normal(n, b, 6))
    e = torch.as_tensor(edges)
    rel = se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])
    meas = se3.compose(rel, se3.exp(0.05 * normal(len(edges), b, 6)))
    init = se3.compose(gt, se3.exp(0.2 * normal(n, b, 6)))
    arrays = dict(gt=gt.numpy(), edges=np.asarray(edges), measurements=meas.numpy(), init=init.numpy(),
                  prior_weight=10.0)
    obj, inputs = problem_from_arrays(arrays, dtype=dtype, device="cpu")
    co = obj.compile()
    vals = obj.default_values(inputs)
    state, aux = co.pack(vals, b), co.build_aux(vals, b)
    bld = SparseNormalBuilder(co)
    ata, atb = pasm.assemble(bld.pattern, co.linearize_blocks(state, aux))
    return bld.sched, pasm.apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8), atb


# ---- the gathered-operand plan: gather, operand arithmetic, mask, scatter --
def _gathered_factorize(sched, ata):
    _, _, levels = sched.on(ata.device)
    bsz, d = ata.shape[1], ata.shape[-1]
    lflat = torch.zeros((sched.sym.nnz_l + 1, bsz, d, d), dtype=ata.dtype)
    for t in levels:
        col_a, ks, kj = factor_operands(t, ata, lflat)
        c = col_a - torch.einsum("curbik,cubjk->crbij", ks, kj)
        ld = chol_small(0.5 * (c[:, 0] + c[:, 0].transpose(-1, -2)))
        newcol = torch.cat([ld[:, None], rt_solve_lower(ld[:, None], c[:, 1:])], dim=1)
        lflat[t["col_slots"].long()] = torch.where(t["valid"][:, :, None, None, None], newcol, 0.0)
    tail = _tail_dense_eliminate(sched, ata, lflat) if sched.tail_k else None
    return Factor(lflat, tail)


def _gathered_solve(sched, factor, atb):
    perm, iperm, levels = sched.on(atb.device)
    b_perm = atb[perm]
    y = torch.zeros_like(b_perm)
    for t in levels:
        ljk, yk, bc, ldiag = fwd_operands(t, factor.blocks, y, b_perm)
        y[t["cols"].long()] = solve_lower_vec(ldiag, bc - torch.einsum("cubij,cubj->cbi", ljk, yk))
    if sched.tail_k:
        y[sched.n_head:] = _tail_fwd_solve(sched, factor, y, b_perm)
    x = torch.zeros_like(y)
    if sched.tail_k:
        x[sched.n_head:] = _tail_bwd_solve(sched, factor, y)
    for t in reversed(levels):
        lcol, xr, yc = bwd_operands(t, factor.blocks, x, y)
        acc = yc - torch.einsum("crbij,crbi->cbj", lcol[:, 1:], xr[:, 1:])
        x[t["cols"].long()] = solve_upper_vec(lcol[:, 0].transpose(-1, -2), acc)
    return y, x[iperm]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_in_place_plan_is_the_gathered_plan_bit_for_bit(name, dtype):
    sched, ata, atb = _system(name, dtype)
    factor = factorize_levels(sched, ata)
    want = _gathered_factorize(sched, ata)
    assert torch.equal(factor.blocks, want.blocks)
    assert (factor.tail is None) == (want.tail is None)
    if factor.tail is not None:
        assert torch.equal(factor.tail, want.tail)
    y_want, x_want = _gathered_solve(sched, want, atb)
    perm, _, _ = sched.on(atb.device)
    assert torch.equal(forward_sweep(sched, factor, atb[perm]), y_want)
    assert torch.equal(solve_levels(sched, factor, atb), x_want)
    assert bool(torch.isfinite(x_want).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_slot_zero_stays_the_zero_block(name, dtype):
    sched, ata, _ = _system(name, dtype)
    blocks = factorize_levels(sched, ata).blocks
    assert torch.equal(blocks[0], torch.zeros_like(blocks[0]))
    # the tail's own slots are not the head's to write either
    tail_slots = [s for (r, j), s in sched.sym.block_of.items() if j >= sched.n_head]
    assert not blocks[tail_slots].any()


def _updates_from_zero(sched):
    """The head columns whose y reads column 0's, directly or through
    others: j with an update k in that set, in elimination order."""
    dep = np.zeros(sched.n_head, dtype=bool)
    dep[0] = True
    for j in range(1, sched.n_head):
        dep[j] = any(dep[int(k)] for k in sched.sym.upd_lists[j])
    return dep


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", [g for g in GRAPHS if g != "clique16"])
def test_padded_terms_read_zero_not_row_zero(name, dtype):
    """The forward sweep with b's row 0 NaN: y's row 0 is NaN, and so are
    exactly the columns that update from it; the padded updates, whose
    tables point at row 0, leave every other column's y as it was. The
    backward sweep from x with row 0 NaN gives the x of a zero start."""
    sched, ata, atb = _system(name, dtype)
    assert sched.n_head > 0
    perm, _, levels = sched.on(atb.device)
    assert any(not (t["upd_valid"].all() and t["valid"].all()) for t in levels)  # some padding
    factor = factorize_levels(sched, ata)
    b_perm = atb[perm]
    y_ref = forward_sweep(sched, factor, b_perm)
    b_nan = b_perm.clone()
    b_nan[0] = float("nan")
    y = torch.zeros_like(b_nan)
    level_fwd_subst(levels, factor.blocks, y, b_nan)
    dep = torch.as_tensor(_updates_from_zero(sched))
    nh = sched.n_head
    assert 0 < int(dep.sum()) < nh
    assert torch.equal(torch.isnan(y[:nh]).flatten(1).all(1), dep)
    assert not torch.isnan(y[:nh][~dep]).any()
    assert torch.equal(y[:nh][~dep], y_ref[:nh][~dep])

    x_ref = backward_sweep(sched, factor, y_ref)
    x = torch.zeros_like(y_ref)
    x[nh:] = x_ref[nh:]
    x[0] = float("nan")
    level_bwd_subst(reversed(levels), factor.blocks, x, y_ref)
    assert bool(torch.isfinite(x).all())
    assert torch.equal(x, x_ref)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_level_tables_fit_the_arrays(name):
    """Each level's `need` bounds what its tables reach, and its record holds
    the valid rows and updates as prefixes, the transposed AtA slots
    negated."""
    sched, ata, atb = _system(name, torch.float64)
    _, _, levels = sched.on(ata.device)
    for t, tn in zip(levels, sched.level_tables):
        a, l, v = t["need"]
        assert a <= ata.shape[0] and l <= sched.sym.nnz_l + 1 and v <= atb.shape[0]
        C, rl, ul = t["dims"]
        rec = level_record(tn)
        assert rec.dtype == np.int32 and len(rec) == 4 * C + 3 * C * rl + 2 * C * ul + C * ul * rl
        nrow, nupd = rec[C:2 * C], rec[2 * C:3 * C]
        assert (tn["valid"] == (np.arange(rl)[None, :] < nrow[:, None])).all()
        assert (tn["upd_valid"] == (np.arange(ul)[None, :] < nupd[:, None])).all()
        a_src = rec[4 * C:4 * C + C * rl].reshape(C, rl)
        assert (np.abs(a_src) == tn["a_src"]).all() and ((a_src < 0) == tn["a_tr"]).all()
        for k in ("cols", "col_slots", "upd_slots", "a_src"):  # views of the record: one copy on the device
            assert t[k].dtype == torch.int32
            assert t[k].untyped_storage().data_ptr() == t["rec"].untyped_storage().data_ptr()
        assert torch.equal(t["a_src"], torch.as_tensor(a_src))


def test_record_refuses_a_padded_entry_before_a_valid_one():
    """The kernels read a column's first nrow rows and nupd updates: a table
    whose valid entries do not lead is refused, as is a column without its
    diagonal row."""
    sched, _, _ = _system("chain16", torch.float64)
    tn = next(t for t in sched.level_tables if t["upd_valid"].shape[1] >= 2)
    bad = {k: v.copy() for k, v in tn.items()}
    bad["upd_valid"][0] = False
    bad["upd_valid"][0, 1] = True
    with pytest.raises(ValueError):
        level_record(bad)
    bad = {k: v.copy() for k, v in tn.items()}
    bad["valid"][0] = False
    with pytest.raises(ValueError):
        level_record(bad)


# ---- the launch path on the CPU: the wrappers' ctypes calls read back ------
def _record(rec, C, rl, ul):
    """csrc/common.cuh LevelRecord's sections of a record, as the kernels
    find them from (C, rl, ul)."""
    r, out, off = rec.numpy(), {}, 0
    for name, size, shape in (("cols", C, (C,)), ("nrow", C, (C,)), ("nupd", C, (C,)), ("diag", C, (C,)),
                              ("a_src", C * rl, (C, rl)), ("col_slots", C * rl, (C, rl)),
                              ("row_ids", C * rl, (C, rl)), ("jk_slots", C * ul, (C, ul)),
                              ("upd_k", C * ul, (C, ul)), ("upd_slots", C * ul * rl, (C, ul, rl))):
        out[name] = r[off:off + size].reshape(shape)
        off += size
    assert off == len(r)
    return out


class _KernelModel:
    """Stands in for the kernel library: each entry point finds the tensors
    its pointer arguments point at and runs the kernel's arithmetic column
    by column from the record, reading only a column's nrow rows and nupd
    updates, and writing in place."""

    def __init__(self, tensors):
        self.at = {t.data_ptr(): t for t in tensors}

    def _level(self, rec_p, C, rl, ul):
        return _record(self.at[rec_p], C, rl, ul)

    def factor(self, ata_p, l_p, rec_p, C, rl, ul, B, d, stream):
        ata, lf, r = self.at[ata_p], self.at[l_p], self._level(rec_p, C, rl, ul)
        for c in range(C):
            rows = []
            for i in range(r["nrow"][c]):
                s = int(r["a_src"][c, i])
                a = ata[-s].transpose(-1, -2) if s < 0 else ata[s]
                for u in range(r["nupd"][c]):
                    a = a - lf[r["upd_slots"][c, u, i]] @ lf[r["jk_slots"][c, u]].transpose(-1, -2)
                rows.append(a)
            ld = chol_small(0.5 * (rows[0] + rows[0].transpose(-1, -2)))
            lf[r["col_slots"][c, 0]] = ld
            for i in range(1, len(rows)):
                lf[r["col_slots"][c, i]] = rt_solve_lower(ld, rows[i])
        return 0

    def fwd(self, l_p, y_p, b_p, rec_p, C, rl, ul, B, d, bt, gu, uc, stream):
        lf, y, b, r = self.at[l_p], self.at[y_p], self.at[b_p], self._level(rec_p, C, rl, ul)
        for c in range(C):
            acc = b[r["cols"][c]].clone()
            for u in range(r["nupd"][c]):
                acc -= (lf[r["jk_slots"][c, u]] @ y[r["upd_k"][c, u]][..., None])[..., 0]
            y[r["cols"][c]] = solve_lower_vec(lf[r["diag"][c]], acc)
        return 0

    def bwd(self, l_p, x_p, y_p, rec_p, C, rl, ul, B, d, bt, rc, stream):
        lf, x, y, r = self.at[l_p], self.at[x_p], self.at[y_p], self._level(rec_p, C, rl, ul)
        for c in range(C):
            acc = y[r["cols"][c]].clone()
            for i in range(1, r["nrow"][c]):
                acc -= (lf[r["col_slots"][c, i]].transpose(-1, -2) @ x[r["row_ids"][c, i]][..., None])[..., 0]
            x[r["cols"][c]] = solve_upper_vec(lf[r["col_slots"][c, 0]].transpose(-1, -2), acc)
        return 0

    def __getattr__(self, name):
        kind = name[len("th_level_"):].rsplit("_", 1)[0]
        return {"factor": self.factor, "fwd_subst": self.fwd, "bwd_subst": self.bwd}[kind]


@pytest.mark.parametrize("name", ["grid6", "chain64"])
def test_launch_path_arguments_read_by_a_kernel_model(name, monkeypatch):
    """The wrappers' launch path, run on the CPU against `_KernelModel`: the
    ctypes arguments (pointers, record, C, rl, ul, B, d) in the order the
    C entry points take them, one call a level and stage, the counters; the
    model's factor, y and x match the twins' to 1e-12 in float64, slot 0
    stays zero, and b's row 0 NaN reaches only the columns that update from
    column 0."""
    import contextlib

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.sparse import level_kernels as lk

    sched, ata, atb = _system(name, torch.float64)
    perm, _, levels = sched.on(ata.device)
    want = factorize_levels(sched, ata)
    b_perm = atb[perm]
    y_want = forward_sweep(sched, want, b_perm)
    x_want = backward_sweep(sched, want, y_want)

    nh, bsz, d = sched.n_head, ata.shape[1], ata.shape[-1]
    lflat = torch.zeros_like(want.blocks)
    y, x = torch.zeros_like(b_perm), torch.zeros_like(b_perm)
    x[nh:] = x_want[nh:]
    b_nan = b_perm.clone()
    b_nan[0] = float("nan")
    y_nan = torch.zeros_like(b_perm)
    model = _KernelModel([ata, lflat, y, x, b_perm, b_nan, y_nan] + [t["rec"] for t in levels])
    monkeypatch.setattr(lk, "use_kernel", lambda t: True)
    monkeypatch.setattr(_cuda, "lib", lambda: model)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(_cuda, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    _cuda.reset_launches()
    lk.level_factor(levels, ata, lflat)
    lk.level_fwd_subst(levels, lflat, y, b_perm)
    lk.level_bwd_subst(reversed(levels), lflat, x, y)
    assert all(_cuda.launches[k] == len(levels) for k in ("level_factor", "level_fwd_subst", "level_bwd_subst"))
    assert not lflat[0].any()
    for got, ref in ((lflat, want.blocks), (y[:nh], y_want[:nh]), (x, x_want)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-12 * float(ref.abs().max()), rtol=0)
    lk.level_fwd_subst(levels, lflat, y_nan, b_nan)
    with pytest.raises(ValueError):  # tables that reach past the arrays launch nothing
        lk.level_factor(levels, ata, lflat[:1])
    with pytest.raises(ValueError):
        lk.level_bwd_subst(levels, lflat, x[:1], y[:1])
    dep = torch.as_tensor(_updates_from_zero(sched))
    assert torch.equal(torch.isnan(y_nan[:nh]).flatten(1).all(1), dep)
    assert bool(torch.isfinite(y_nan[:nh][~dep]).all())
    _cuda.reset_launches()
