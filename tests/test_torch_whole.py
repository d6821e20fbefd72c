"""The whole-sweep plan of theseus_tpu_torch (sparse/whole.py) against the JAX package, on the CPU.

On the CPU the three whole-sweep wrappers run their plain twin, the
per-column left-looking plan of sparse/cholesky.py (the JAX package's
`_factorize_scan` / `_solve_scan` / `_bwd_scan`). Both packages get the same
PGO problem arrays (the JAX package's generator, carried over with
utils/convert.py); the port factors the JAX package's assembled, damped AtA.
Checked, in float64:

- the per-column tables (`NumericSchedule.a_src ... upd_valid`) EXACTLY
  equal to the JAX package's;
- the twin's factor and solve against JAX `factorize` / `solve_with_factor`,
  the reference JAX's own tests hold the whole-sweep kernels to, at 1e-12
  relative to the largest entry (the same arithmetic in another summation
  order), and against the interpret-mode JAX whole-sweep kernels at 16 x 4;
- the wrappers' conventions (b in the original order, y in elimination
  order, x back in the original order) and the plan gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.optim.normal import SparseNormalBuilder as JBuilder
from theseus_tpu.sparse import cholesky as jchol
from theseus_tpu.sparse.assemble import apply_block_damping as japply_damping
from theseus_tpu.sparse.assemble import assemble as jassemble
from theseus_tpu.utils.examples.pose_graph import (
    build_pgo_objective as jbuild,
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic,
)
from theseus_tpu_torch import config
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse import cholesky as pchol
from theseus_tpu_torch.sparse import whole
from theseus_tpu_torch.utils.convert import problem_from_arrays

RECT = ("a_src", "a_tr", "valid", "col_slots", "col_row_ids", "row_valid", "upd_slots",
        "upd_jk_slots", "upd_k", "upd_valid")
_CACHE = {}


def _system(n, b):
    """(jax builder, jax ata, jax atb, port builder): the JAX package's damped
    PGO system (the setup of its own whole-sweep tests) and the port's
    builder for the same problem."""
    if (n, b) not in _CACHE:
        gt, edges, meas, init = jsynthetic(n_poses=n, batch=b, seed=0, dtype=jnp.float64)
        jobj, _ = jbuild(n, edges, meas, gt[0], dtype=jnp.float64)
        jco = jobj.compile()
        jb = JBuilder(jco)
        vals = jobj.default_values(jpose_values(init))
        state, aux = jco.pack(vals, b), jco.build_aux(vals, b)
        ata, atb = jassemble(jb.pattern, jco, jco.linearize_blocks(state, aux))
        ata = japply_damping(jb.pattern, ata, 1e-3, True, jb.damping_eps)
        arrays = dict(gt=np.asarray(gt), edges=np.asarray(edges), measurements=np.asarray(meas),
                      init=np.asarray(init), prior_weight=10.0)
        pobj, _ = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
        _CACHE[(n, b)] = (jb, ata, atb, SparseNormalBuilder(pobj.compile()))
    return _CACHE[(n, b)]


def _rel_close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-300), rtol=0)


@pytest.mark.parametrize("n,b", [(16, 4), (48, 8)])
def test_rect_tables_equal_jax(n, b):
    jb, _, _, pb = _system(n, b)
    for k in RECT:
        np.testing.assert_array_equal(getattr(pb.sched, k), getattr(jb.sched, k), err_msg=k)


@pytest.mark.parametrize("n,b", [(16, 4), (48, 8)])
def test_whole_twin_matches_jax(n, b):
    jb, ata, atb, pb = _system(n, b)
    lref = jchol.factorize(jb.sched, ata)
    xref = jchol.solve_with_factor(jb.sched, lref, atb)
    factor = whole.whole_factor(pb.sched, torch.as_tensor(np.array(ata)))
    assert factor.tail is None
    _rel_close(factor.blocks, lref, 1e-12)
    assert float(factor.blocks[0].abs().max()) == 0.0
    x = whole.solve_whole(pb.sched, factor, torch.as_tensor(np.array(atb)))
    _rel_close(x, xref, 1e-12)


def test_whole_twin_matches_jax_interpret_kernels():
    """The JAX package's whole-sweep kernels themselves, in Pallas interpret
    mode (~10 s at 16 x 4), against the port's twin."""
    from theseus_tpu.sparse import pallas_whole as pw
    from theseus_tpu.sparse.pallas_factorize import soa_to_aos

    jb, ata, atb, pb = _system(16, 4)
    d = jb.pattern.d
    lsoa = pw.factorize_whole(jb.sched, ata, interpret=True)
    laos = soa_to_aos(lsoa[: jb.sched.sym.nnz_l + 1, : d * d, :4], d)
    factor = whole.whole_factor(pb.sched, torch.as_tensor(np.array(ata)))
    _rel_close(factor.blocks, laos, 1e-12)
    xk = pw.solve_whole(jb.sched, lsoa, atb, interpret=True)
    _rel_close(whole.solve_whole(pb.sched, factor, torch.as_tensor(np.array(atb))), xk, 1e-12)


def test_whole_wrappers_orders_and_level_plan():
    """y leaves in elimination order (the level plan's forward sweep of
    b[perm]); x leaves in the original order; the factor equals the level
    plan's slot for slot."""
    _, ata, atb, pb = _system(48, 8)
    sched = pb.sched
    ata, atb = torch.as_tensor(np.array(ata)), torch.as_tensor(np.array(atb))
    factor = whole.whole_factor(sched, ata)
    llev = pchol.factorize_levels(sched, ata)
    _rel_close(factor.blocks, llev.blocks, 1e-12)
    perm, _, _ = sched.on(atb.device)
    y = whole.whole_fwd_subst(sched, factor, atb)
    _rel_close(y, pchol.forward_sweep(sched, llev, atb[perm]), 1e-12)
    x = whole.whole_bwd_subst(sched, factor, y)
    _rel_close(x, pchol.solve_levels(sched, llev, atb), 1e-12)


def test_whole_tables_cover_every_column_once():
    _, _, _, pb = _system(48, 8)
    t = whole.get_tables(pb.sched)
    order = np.concatenate(t.levels)
    assert sorted(order.tolist()) == list(range(pb.sched.n_head))
    assert t.n_levels == len(t.levels) == len(pb.sched.level_tables)
    assert all(a.dtype == np.int32 for a in t.host.values())
    # a column's update sources lie in earlier levels
    level_of = np.empty(len(order), np.int64)
    for lv, cols in enumerate(t.levels):
        level_of[cols] = lv
    for j in range(pb.sched.n_head):
        ks = t.host["upd_k"][j, : t.host["ucount"][j]]
        assert (level_of[ks] < level_of[j]).all()


@pytest.mark.parametrize("enabled", [False, True])
def test_plan_gate(enabled, monkeypatch):
    """config.set_whole_sweep selects the plan of factorize /
    solve_with_factor; both give the same solve."""
    _, ata, atb, pb = _system(16, 4)
    ata, atb = torch.as_tensor(np.array(ata)), torch.as_tensor(np.array(atb))
    calls = []
    monkeypatch.setattr(pchol, "whole_factor", lambda s, a: calls.append("whole") or whole.whole_factor(s, a))
    config.set_whole_sweep(enabled)
    try:
        assert pchol._use_whole(pb.sched) is enabled
        x = pchol.sparse_block_solve(pb.sched, ata, atb)
    finally:
        config.set_whole_sweep(False)
    assert calls == (["whole"] if enabled else [])
    _rel_close(x, pchol.solve_levels(pb.sched, pchol.factorize_levels(pb.sched, ata), atb), 1e-12)
