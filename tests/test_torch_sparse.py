"""Block-sparse machinery of theseus_tpu_torch against the JAX package, on the CPU.

Both packages get the same PGO problem arrays (made by the JAX package's
generator, carried over with theseus_tpu_torch.utils.convert). Checked:

- symbolic tables (block pattern, ordering, fill, etree levels and every
  per-level table) EXACTLY equal;
- linearization blocks and the AtA / Atb assembly (the assembly kernel's
  plain twin) against `_assemble_xla`, float64, 1e-12 relative to the
  largest entry;
- the level factorization and both substitutions (the level kernels'
  twins) against `_factorize_levels` / `_solve_levels`, float64, 1e-10
  relative (a Cholesky solve amplifies rounding by the system's condition);
- damping, the refinement SpMV and the float64 Atb of the high-precision
  tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.optim.normal import SparseNormalBuilder as JBuilder
from theseus_tpu.sparse import assemble as jasm
from theseus_tpu.sparse import cholesky as jchol
from theseus_tpu.sparse import refine as jref
from theseus_tpu.utils.examples.pose_graph import (
    build_pgo_objective as jbuild,
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic,
)
from theseus_tpu_torch import config
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse import assemble as pasm
from theseus_tpu_torch.sparse import cholesky as pchol
from theseus_tpu_torch.sparse import refine as pref
from theseus_tpu_torch.utils.convert import problem_from_arrays

_CACHE = {}


def _problem(n, b, dtype=jnp.float64):
    """(jax compiled objective, state, aux, port compiled objective, state, aux)."""
    key = (n, b, np.dtype(dtype).name)
    if key not in _CACHE:
        gt, edges, meas, init = jsynthetic(n_poses=n, batch=b, seed=0, dtype=dtype)
        jobj, _ = jbuild(n, edges, meas, gt[0], dtype=dtype)
        jco = jobj.compile()
        jvals = jobj.default_values(jpose_values(init))
        jstate, jaux = jco.pack(jvals, b), jco.build_aux(jvals, b)
        arrays = dict(gt=np.asarray(gt), edges=np.asarray(edges), measurements=np.asarray(meas),
                      init=np.asarray(init), prior_weight=10.0)
        tdt = torch.float64 if dtype == jnp.float64 else torch.float32
        pobj, inputs = problem_from_arrays(arrays, dtype=tdt, device="cpu")
        pco = pobj.compile()
        pvals = pobj.default_values(inputs)
        pstate, paux = pco.pack(pvals, b), pco.build_aux(pvals, b)
        _CACHE[key] = (jco, jstate, jaux, pco, pstate, paux)
    return _CACHE[key]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_close(got, want, rtol):
    got, want = _np(got), _np(want)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


# ---------------------------------------------------------------------------
# symbolic tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("ordering", ["auto", "amd", "nd"])
def test_symbolic_tables_equal(n, ordering):
    jco, _, _, pco, _, _ = _problem(n, 2)
    jb, pb = JBuilder(jco, ordering=ordering), SparseNormalBuilder(pco, ordering=ordering)
    jp, pp = jb.pattern, pb.pattern
    assert (jp.n_vars, jp.d, jp.n_slots) == (pp.n_vars, pp.d, pp.n_slots)
    assert jp.pair_slot == pp.pair_slot and jp.pairs == pp.pairs
    for jsched, psched in zip(jp.bucket_pair_sched, pp.bucket_pair_sched):
        for ja, pa in zip(jsched, psched):
            assert ja[:2] == pa[:2]
            for x, y in zip(ja[2:], pa[2:]):
                np.testing.assert_array_equal(x, y)
    for jg, pg in zip(jp.bucket_gvars, pp.bucket_gvars):
        for x, y in zip(jg, pg):
            np.testing.assert_array_equal(x, y)

    js, ps = jb.sym, pb.sym
    np.testing.assert_array_equal(js.perm, ps.perm)
    np.testing.assert_array_equal(js.iperm, ps.iperm)
    np.testing.assert_array_equal(js.etree_parent, ps.etree_parent)
    assert (js.nnz_l, js.tail_start) == (ps.nnz_l, ps.tail_start)
    assert js.block_of == ps.block_of
    for x, y in zip(js.col_rows, ps.col_rows):
        np.testing.assert_array_equal(x, y)
    assert len(js.levels) == len(ps.levels)
    for x, y in zip(js.levels, ps.levels):
        np.testing.assert_array_equal(x, y)

    # every per-level table; the JAX package caps its level plan at
    # max(8, n/4) levels, so below that it is asked for the tables directly
    jtables = (jb.sched.level_tables if jb.sched.use_levels
               else [jb.sched._build_level_table(c) for c in js.levels])
    assert len(jtables) == len(pb.sched.level_tables)
    for jt, pt in zip(jtables, pb.sched.level_tables):
        assert set(jt) == set(pt)
        for k in jt:
            np.testing.assert_array_equal(jt[k], pt[k], err_msg=k)


# ---------------------------------------------------------------------------
# linearization and assembly
# ---------------------------------------------------------------------------
def _blocks(n, b):
    jco, jstate, jaux, pco, pstate, paux = _problem(n, b)
    jblocks = jax.jit(jco.linearize_blocks)(jstate, jaux)
    pblocks = pco.linearize_blocks(pstate, paux)
    return jco, jblocks, pco, pblocks


def test_linearize_blocks_match():
    _, jblocks, _, pblocks = _blocks(24, 3)
    for (jj, je), (pj, pe) in zip(jblocks, pblocks):
        _rel_close(pe, je, 1e-12)
        for a, b in zip(pj, jj):
            _rel_close(a, b, 1e-12)


def test_error_metric_matches():
    jco, jstate, jaux, pco, pstate, paux = _problem(24, 3)
    _rel_close(pco.error_metric(pstate, paux), jax.jit(jco.error_metric)(jstate, jaux), 1e-12)


def test_assembly_matches_assemble_xla():
    jco, jblocks, pco, _ = _blocks(24, 3)
    pattern = JBuilder(jco).pattern
    want_ata, want_atb = jasm._assemble_xla(pattern, jco, jblocks)
    # the same blocks, bit for bit, into the port's assembly (plain twin)
    pblocks = [([torch.as_tensor(np.array(j)) for j in jacs], torch.as_tensor(np.array(e)))
               for jacs, e in jblocks]
    ata, atb = pasm.assemble(SparseNormalBuilder(pco).pattern, pblocks)
    _rel_close(ata, want_ata, 1e-12)
    _rel_close(atb, want_atb, 1e-12)
    assert not np.any(_np(ata)[0])  # slot 0 stays the zero sentinel


def test_assembly_tables_cover_every_contribution():
    """The kernel's CSR lists hold each (bucket, pair, edge) exactly once."""
    _, _, pco, _ = _blocks(24, 3)
    pat = SparseNormalBuilder(pco).pattern
    t = pat.asm_tables
    n_pairs = sum(len(tgt) for sched in pat.bucket_pair_sched for (_, _, tgt, _, _) in sched)
    n_atb = sum(len(g) for gv in pat.bucket_gvars for g in gv)
    assert t.ata_ptr[-1] == len(t.ata_items) == n_pairs
    assert t.atb_ptr[-1] == len(t.atb_items) == n_atb
    assert t.ata_ptr[1] == 0  # nothing lands on the sentinel slot


def test_block_damping_matches():
    jco, jblocks, pco, pblocks = _blocks(24, 3)
    jpat, ppat = JBuilder(jco).pattern, SparseNormalBuilder(pco).pattern
    jata, _ = jasm._assemble_xla(jpat, jco, jblocks)
    pata, _ = pasm.assemble(ppat, pblocks)
    damp = np.array([1e-3, 0.5, 7.0])
    for ellipsoidal in (False, True):
        want = jasm.apply_block_damping(jpat, jata, jnp.asarray(damp), ellipsoidal, 1e-8)
        got = pasm.apply_block_damping(ppat, pata, torch.as_tensor(damp), ellipsoidal, 1e-8)
        _rel_close(got, want, 1e-12)


def test_high_precision_atb_matches_jax():
    """float32 blocks, Atb accumulated in float64 (the JAX package does this
    under x64, which the tests enable)."""
    jco, jstate, jaux, pco, pstate, paux = _problem(24, 3, dtype=jnp.float32)
    jblocks = jax.jit(jco.linearize_blocks)(jstate, jaux)
    want = jasm._assemble_atb_hp(JBuilder(jco).pattern, jblocks, jnp.float32)
    pblocks = [([torch.as_tensor(np.array(j)) for j in jacs], torch.as_tensor(np.array(e)))
               for jacs, e in jblocks]
    config.set_high_precision_tier(True)
    try:
        _, atb = pasm.assemble(SparseNormalBuilder(pco).pattern, pblocks)
    finally:
        config.set_high_precision_tier(False)
    assert atb.dtype == torch.float32
    # both round one float64 sum to float32: at most one ulp apart
    np.testing.assert_allclose(_np(atb), np.asarray(want), rtol=2e-7, atol=1e-12)


# ---------------------------------------------------------------------------
# factorization, substitution, refinement
# ---------------------------------------------------------------------------
def _systems(n, b):
    jco, jblocks, pco, pblocks = _blocks(n, b)
    jbld, pbld = JBuilder(jco), SparseNormalBuilder(pco)
    jata, jatb = jasm._assemble_xla(jbld.pattern, jco, jblocks)
    jata = jasm.apply_block_damping(jbld.pattern, jata, 1e-3, False, 1e-8)
    pata, patb = pasm.assemble(pbld.pattern, pblocks)
    pata = pasm.apply_block_damping(pbld.pattern, pata, 1e-3, False, 1e-8)
    return jbld, jata, jatb, pbld, pata, patb


@pytest.mark.parametrize("n", [16, 64])
def test_level_factorization_and_solve_match(n):
    jbld, jata, jatb, pbld, pata, patb = _systems(n, 3)
    sched = jbld.sched
    if sched.use_levels:  # the JAX level plan itself
        fact, solve = jchol._factorize_levels, jchol._solve_levels
    else:  # below its cap the JAX package factors column by column
        fact, solve = jchol._factorize_scan, jchol._solve_scan
    want_l = jax.jit(lambda a: fact(sched, a))(jata)
    want_x = jax.jit(lambda l, b: solve(sched, l, b))(want_l, jatb)
    factor = pchol.factorize(pbld.sched, pata)
    x = pchol.solve_with_factor(pbld.sched, factor, patb)
    assert factor.tail is None
    _rel_close(factor.blocks, want_l, 1e-10)
    _rel_close(x, want_x, 1e-10)
    _rel_close(pchol.sparse_block_solve(pbld.sched, pata, patb), want_x, 1e-10)


def test_nonpositive_pivot_gives_nonfinite_delta_not_exception():
    _, _, _, pbld, pata, patb = _systems(16, 3)
    bad = pata.clone()
    bad[1, 1] = -bad[1, 1]  # batch element 1: diagonal block of var 0 made negative definite
    x = pchol.sparse_block_solve(pbld.sched, bad, patb)
    assert not torch.isfinite(x[:, 1]).all()
    assert torch.isfinite(x[:, 0]).all() and torch.isfinite(x[:, 2]).all()


def test_block_matvec_matches():
    jbld, jata, _, pbld, pata, _ = _systems(24, 3)
    rng = np.random.default_rng(0)
    xv = rng.standard_normal((pbld.pattern.n_vars, 3, pbld.pattern.d))
    want = jref.block_matvec(jbld.sched.matvec_tables(), jata, jnp.asarray(xv))
    got = pref.block_matvec(pbld.pattern.matvec_tables(pata.device), pata, torch.as_tensor(xv))
    _rel_close(got, want, 1e-12)


def test_refinement_reaches_float64_solution():
    """float32 factor + one refinement sweep with float64 residuals lands
    much closer to the exact solution of the (float32) system than the plain
    float32 solve does."""
    _, _, _, pbld, pata, patb = _systems(64, 3)
    a32, b32 = pata.float(), patb.float()
    exact = pchol.sparse_block_solve(pbld.sched, a32.double(), b32.double())
    plain = pchol.sparse_block_solve(pbld.sched, a32, b32)
    config.set_high_precision_tier(True)
    try:
        refined = pchol.sparse_block_solve(pbld.sched, a32, b32)
    finally:
        config.set_high_precision_tier(False)
    err_plain = (plain.double() - exact).abs().max()
    err_refined = (refined.double() - exact).abs().max()
    assert err_refined < 0.1 * err_plain, (err_refined, err_plain)
