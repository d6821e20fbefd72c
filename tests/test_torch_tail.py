"""The dense trailing supernode of theseus_tpu_torch against the JAX package, on the CPU.

Any graph denser than a chain gets a dense tail under the default
`SPARSE_DENSE_TAIL`: the symbolic analysis folds its last columns into one
supernode, which the numeric layer factors with one batched dense POTRF
after the head's levels. Three graphs, each a PGO problem whose arrays are
made from a numpy seed and handed to both packages, float64:

- a 6 x 6 and an 8 x 8 grid (36 and 64 poses: a head of etree levels and
  a tail of 16 to 22 columns);
- a 16-pose clique (all of it tail, no head).

Checked: the tail tables the port keeps equal the JAX `NumericSchedule`'s,
and the `tail_update` kernel's lists equal lists built from the JAX
package's padded tables; the factor's head blocks against JAX's Lflat and
its dense tail against JAX's `_tail_dense_L`, and the solve against the JAX
solve, to 1e-10 relative (a Cholesky solve amplifies rounding by the
system's condition, as in tests/test_torch_sparse.py); a
30-iteration LM solve's final error to 1e-8 relative (converged float64
plateaus); the implicit outer gradient to 1e-6 (tests/test_torch_backward.py's
bound); a tail that is not positive definite gives NaN for its batch
element only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu import lie as jlie
from theseus_tpu.embodied import Between as JBetween
from theseus_tpu.embodied import Local as JLocal
from theseus_tpu.optim.normal import SparseNormalBuilder as JBuilder
from theseus_tpu.sparse import assemble as jasm
from theseus_tpu.sparse import cholesky as jchol
from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild
from theseus_tpu.utils.examples.pose_graph import pose_values as jpose_values
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse import assemble as pasm
from theseus_tpu_torch.sparse import cholesky as pchol
from theseus_tpu_torch.utils.convert import problem_from_arrays
from theseus_tpu_torch.utils.examples.pose_graph import (
    build_pgo_objective,
    mean_sq_local,
    pose_values,
    training_weights,
)


def grid_edges(rows, cols):
    """A rows x cols grid, its poses numbered along the chain that snakes
    through it row by row: first that chain (n - 1 edges, the odometry),
    then every other grid edge (the loop closures). Numbered so, the poses
    enter the objective in index order, as the training loss reads them."""
    at = lambda i, j: i * cols + (j if i % 2 == 0 else cols - 1 - j)  # noqa: E731
    chain = [(k, k + 1) for k in range(rows * cols - 1)]
    vertical = [(min(at(i, j), at(i + 1, j)), max(at(i, j), at(i + 1, j)))
                for i in range(rows - 1) for j in range(cols)]
    return chain + [e for e in vertical if e[1] - e[0] > 1]


def clique_edges(n):
    chain = [(i, i + 1) for i in range(n - 1)]
    return chain + [(i, j) for i in range(n) for j in range(i + 2, n)]


GRAPHS = {"grid6": (36, grid_edges(6, 6)), "grid8": (64, grid_edges(8, 8)), "clique16": (16, clique_edges(16))}


@functools.lru_cache(maxsize=None)
def _arrays(name, b, seed=0):
    """Ground truth, measurements (with noise) and a noisy initialization,
    float64 numpy, from a numpy Generator."""
    n, edges = GRAPHS[name]
    rng = np.random.default_rng(seed)
    normal = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    gt = se3.exp(0.5 * normal(n, b, 6))
    e = torch.as_tensor(edges)
    rel = se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])
    meas = se3.compose(rel, se3.exp(0.05 * normal(len(edges), b, 6)))
    init = se3.compose(gt, se3.exp(0.2 * normal(n, b, 6)))
    return dict(gt=gt.numpy(), edges=np.asarray(edges), measurements=meas.numpy(), init=init.numpy(),
                prior_weight=10.0)


@functools.lru_cache(maxsize=None)
def _system(name, b=3):
    """The LM-damped system of each package on the same problem:
    (JAX builder, ata, atb, port builder, ata, atb)."""
    a = _arrays(name, b)
    n, edges = GRAPHS[name]
    jobj, _ = jbuild(n, edges, a["measurements"], a["gt"][0], dtype=jnp.float64)
    jco = jobj.compile()
    jvals = jobj.default_values(jpose_values(a["init"]))
    jstate, jaux = jco.pack(jvals, b), jco.build_aux(jvals, b)
    jb = JBuilder(jco)
    jata, jatb = jasm._assemble_xla(jb.pattern, jco, jco.linearize_blocks(jstate, jaux))
    jata = jasm.apply_block_damping(jb.pattern, jata, 1e-3, False, 1e-8)

    pobj, inputs = problem_from_arrays(a, dtype=torch.float64, device="cpu")
    pco = pobj.compile()
    pvals = pobj.default_values(inputs)
    pstate, paux = pco.pack(pvals, b), pco.build_aux(pvals, b)
    pb = SparseNormalBuilder(pco)
    pata, patb = pasm.assemble(pb.pattern, pco.linearize_blocks(pstate, paux))
    pata = pasm.apply_block_damping(pb.pattern, pata, 1e-3, False, 1e-8)
    return jb, jata, jatb, pb, pata, patb


def _rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-300), rtol=0)


TAIL_TABLES = ("tail_upd_jk", "tail_upd_k", "tail_upd_valid")


def kernel_lists(js):
    """(out, pair_ptr, pairs) of the `tail_update` kernel from the JAX
    schedule's padded tables: the K (K + 1) / 2 output blocks (j, r >= j)
    j-major, each with its AtA slot and transpose flag, and the pairs
    (slot of L[r, k], slot of L[j, k]) of its external updates whose both
    blocks exist, in update order."""
    K = js.tail_k
    jj, rr = np.triu_indices(K)
    out = np.stack([jj, rr, js.tail_a_src[jj, rr], js.tail_a_tr[jj, rr]], axis=1)
    pairs, ptr = [], [0]
    for j, r in zip(jj, rr):
        for u in range(js.tail_ue):
            if js.tail_upd_valid[j, u] and js.tail_upd_slots[j, u, r]:
                pairs.append((js.tail_upd_slots[j, u, r], js.tail_upd_jk[j, u]))
        ptr.append(len(pairs))
    return out, np.asarray(ptr), np.asarray(pairs).reshape(-1, 2)


@pytest.mark.parametrize("name", ["grid6", "grid8", "clique16"])
def test_tail_tables_equal(name):
    jb, _, _, pb, _, _ = _system(name)
    js, ps = jb.sched, pb.sched
    assert (ps.n_head, ps.tail_k) == (js.n_head, js.tail_k)
    assert ps.tail_k > 0 and (ps.n_head > 0) == name.startswith("grid")
    assert ps.tail_ue == js.tail_ue
    for k in TAIL_TABLES:
        np.testing.assert_array_equal(getattr(ps, k), getattr(js, k), err_msg=k)
    for k, want in zip(("tail_out", "tail_pair_ptr", "tail_pairs"), kernel_lists(js)):
        assert getattr(ps, k).dtype == np.int32
        np.testing.assert_array_equal(getattr(ps, k), want, err_msg=k)
    assert len(ps.level_tables) == len(pb.sym.levels) == len(jb.sym.levels)
    assert (len(ps.level_tables) > 0) == (ps.n_head > 0)


def _tail_slots(js):
    """Lflat slots of the JAX package's tail blocks."""
    return np.unique(js.tail_col_slots[js.tail_valid])


@pytest.mark.parametrize("name", ["grid6", "grid8", "clique16"])
def test_factor_and_solve_match_jax(name):
    """The head's blocks equal JAX's Lflat outside the tail's slots (which
    stay zero), the dense tail JAX's `_tail_dense_L`."""
    jb, jata, jatb, pb, pata, patb = _system(name)
    want_l = jax.jit(lambda a: jchol.factorize(jb.sched, a))(jata)
    want_tail = jchol._tail_dense_L(jb.sched, want_l)
    want_x = jax.jit(lambda a, b: jchol.sparse_block_solve(jb.sched, a, b))(jata, jatb)
    factor = pchol.factorize(pb.sched, pata)
    head = np.ones(factor.blocks.shape[0], dtype=bool)
    head[_tail_slots(jb.sched)] = False
    _rel_close(factor.blocks[torch.as_tensor(head)], np.asarray(want_l)[head], 1e-10)
    assert not factor.blocks[torch.as_tensor(~head)].any()
    _rel_close(factor.tail, want_tail, 1e-10)
    _rel_close(pchol.solve_with_factor(pb.sched, factor, patb), want_x, 1e-10)
    _rel_close(pchol.sparse_block_solve(pb.sched, pata, patb), want_x, 1e-10)


def test_whole_sweep_setting_runs_the_level_plan_on_a_tail():
    """The JAX gate's rule: a tailed schedule never takes the whole-sweep
    plan; with the setting on the solve is the level plan's, bit for bit."""
    _, _, _, pb, pata, patb = _system("grid6")
    want = pchol.sparse_block_solve(pb.sched, pata, patb)
    config.set_whole_sweep(True)
    try:
        assert not pchol._use_whole(pb.sched)
        got = pchol.sparse_block_solve(pb.sched, pata, patb)
    finally:
        config.set_whole_sweep(False)
    assert torch.equal(got, want)


def test_nonpositive_definite_tail_is_nan_for_its_batch_element():
    """Batch element 1's last tail variable gets a negative definite
    diagonal block: its tail factor (and so its step) is NaN, as
    jnp.linalg.cholesky gives; the other batch elements solve."""
    _, _, _, pb, pata, patb = _system("grid6")
    sched = pb.sched
    var = int(sched.perm[sched.sym.n - 1])
    bad = pata.clone()
    slot = pb.pattern.pair_slot[(var, var)]
    bad[slot, 1] = -bad[slot, 1] - 100.0 * torch.eye(6, dtype=bad.dtype)
    factor = pchol.factorize(sched, bad)
    assert torch.isnan(factor.tail[1]).all()
    assert torch.isfinite(factor.tail[0]).all() and torch.isfinite(factor.tail[2]).all()
    assert torch.isfinite(factor.blocks).all()
    x = pchol.sparse_block_solve(sched, bad, patb)
    assert not torch.isfinite(x[:, 1]).any()
    assert torch.isfinite(x[:, 0]).all() and torch.isfinite(x[:, 2]).all()


ITERS = 30


@pytest.mark.parametrize("name", ["grid6", "clique16"])
def test_lm_solve_matches_jax(name):
    n, edges = GRAPHS[name]
    a = _arrays(name, 2)
    jobj, _ = jbuild(n, edges, a["measurements"], a["gt"][0], dtype=jnp.float64)
    jlayer = jt.TheseusLayer(jt.LevenbergMarquardt(
        jobj, max_iterations=ITERS, adaptive_damping=True, linearization="sparse"))
    _, jinfo = jlayer.forward(jpose_values(a["init"]))

    obj, inputs = problem_from_arrays(a, dtype=torch.float64, device="cpu")
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True,
                                                  linearization="sparse"))
    assert layer.optimizer.normal_builder.sched.tail_k > 0
    _, info = layer.forward(inputs)
    assert bool((info.last_err < 0.1 * info.err_history[0]).all())
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=1e-8)


THETA = 1.3


def _jax_implicit(a, n, edges, b):
    """(loss, d loss / d theta) of the JAX package's implicit training step
    (tests/test_torch_backward.py's construction): theta scales the
    loop-closure weights."""
    gt, meas, init = a["gt"], a["measurements"], a["init"]
    w_odo = jt.ScaleCostWeight(jt.Variable(jnp.ones((1, 1)), name="w_odo"))
    w_loop = jt.ScaleCostWeight(jt.Variable(jnp.ones((1, 1)), name="w_loop"))
    obj = jt.Objective(dtype=jnp.float64)
    poses = [jt.SE3(name=f"pose_{i}") for i in range(n)]
    obj.add(JLocal(poses[0], gt[0], jt.ScaleCostWeight(jnp.asarray(10.0)), name="prior"))
    for ei, (i, j) in enumerate(edges):
        obj.add(JBetween(poses[i], poses[j], meas[ei], cost_weight=w_odo if ei < n - 1 else w_loop,
                         name=f"edge_{ei}"))
    opt = jt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True, linearization="sparse")
    layer = jt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values({f"pose_{i}": init[i] for i in range(n)})
    state, aux = co.pack(values, b), co.build_aux(values, b)
    bi = next(i for i, bk in enumerate(co.buckets) if isinstance(bk.template, JBetween))
    loop = jnp.asarray([nm == "w_loop" for nm in co.buckets[bi].weight_slots[0].names])

    def loss(theta):
        aa = list(aux)
        cf, wa = aa[bi]
        aa[bi] = (cf, tuple(w * jnp.where(loop[:, None, None], theta, 1.0) for w in wa))
        carry = layer.solve_state(state, tuple(aa), "implicit", opt.opts, 2)
        d = jax.vmap(jax.vmap(jlie.SE3.local))(carry["state"]["SE3"], jnp.asarray(gt))
        return jnp.mean(jnp.sum(d * d, -1))

    value, grad = jax.value_and_grad(loss)(jnp.asarray(THETA))
    return float(value), float(grad)


def test_implicit_gradient_matches_jax():
    n, edges = GRAPHS["grid6"]
    a = _arrays("grid6", 2)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(n, edges, a["measurements"], a["gt"][0], dtype=torch.float64, device="cpu",
                                 edge_weight=w_odo, loop_weight=w_loop)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True,
                                                  linearization="sparse"))
    assert layer.optimizer.normal_builder.sched.tail_k > 0
    theta = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    out, _ = layer.forward(dict(pose_values(torch.as_tensor(a["init"])), w_loop=theta.reshape(1, 1)),
                           optimizer_kwargs={"backward_mode": "implicit"})
    loss = mean_sq_local(out, torch.as_tensor(a["gt"]))
    loss.backward()
    jloss, jgrad = _jax_implicit(a, n, edges, 2)
    assert float(theta.grad) != 0.0
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-9)
    np.testing.assert_allclose(float(theta.grad), jgrad, rtol=1e-6)
