"""The backward of theseus_tpu_torch against the JAX package, on the CPU.

The same float64 inputs, made with numpy (or by the JAX package's generator
and carried over), go through the port's autograd and through `jax.vjp` /
`jax.grad` of the JAX package:

- `sparse_block_solve`'s VJP (factor reuse, d_atb and d_ata), level and
  whole-sweep plans, against the JAX package's custom VJP: 1e-10 relative
  to the largest entry (a solve with the factor amplifies rounding by the
  system's condition number, as in tests/test_torch_sparse.py);
- the Between linearization's and the block assembly's autograd Functions
  (on the CPU their forward is the twin; the backward is the same code
  that runs on the card) against the VJPs of the JAX package's
  `_reference_linearize` (its `_fused_bwd`) and `_assemble_xla` (its
  `_asm_bwd`): 1e-12, the same formulas;
- SE3 / SO3 `exp` and `log` gradients at random and at exactly zero
  tangents (where the plain formulas would give NaN) against the JAX
  package's custom JVP rules: 1e-12;
- the outer gradient of the flagship training loss (PGO 16 poses x batch 4,
  the loop-closure weight theta, mean squared SE3 local to the ground
  truth): `implicit` (LM, adaptive damping, 30 iterations) at rtol 1e-6, the
  ROADMAP target, and `unroll` / `truncated` (Gauss-Newton, 6 iterations, 2
  backward iterations, as the JAX package's tests/optim/test_sparse.py) at
  rtol 1e-9 (both packages run the same float64 arithmetic in another
  order; measured 3e-13), each with the whole-sweep plan off and on.
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
from theseus_tpu.ops.pallas_between_soa import _reference_linearize
from theseus_tpu.optim.normal import SparseNormalBuilder as JBuilder
from theseus_tpu.sparse import assemble as jasm
from theseus_tpu.sparse import cholesky as jchol
from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild
from theseus_tpu.utils.examples.pose_graph import synthetic_pose_graph as jsynthetic
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se3, so3
from theseus_tpu_torch.ops.between_se3 import between_linearize
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse import cholesky as pchol
from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks
from theseus_tpu_torch.utils.convert import problem_from_arrays
from theseus_tpu_torch.utils.examples.pose_graph import (
    build_pgo_objective,
    mean_sq_local,
    pose_values,
    training_weights,
)

N, B = 16, 4


def _t(x, grad=False):
    return torch.as_tensor(np.array(x)).requires_grad_(grad)


def _rel_close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rtol * max(np.abs(want).max(), 1e-300), rtol=0)


@functools.lru_cache(maxsize=None)
def _arrays():
    gt, edges, meas, init = jsynthetic(n_poses=N, batch=B, seed=0, dtype=jnp.float64)
    return np.asarray(gt), [tuple(map(int, e)) for e in edges], np.asarray(meas), np.asarray(init)


@functools.lru_cache(maxsize=None)
def _system():
    """The JAX package's compiled objective, builder, linearization blocks
    and assembled system at 16 x 4, and the port's builder for the same
    problem."""
    gt, edges, meas, init = _arrays()
    jobj, _ = jbuild(N, edges, meas, gt[0], dtype=jnp.float64)
    jco = jobj.compile()
    jb = JBuilder(jco)
    vals = jobj.default_values({f"pose_{i}": init[i] for i in range(N)})
    state, aux = jco.pack(vals, B), jco.build_aux(vals, B)
    blocks = jco.linearize_blocks(state, aux)
    ata, atb = jasm.assemble(jb.pattern, jco, blocks)
    ata = jasm.apply_block_damping(jb.pattern, ata, 1e-3, True, jb.damping_eps)
    arrays = dict(gt=gt, edges=np.asarray(edges), measurements=meas, init=init, prior_weight=10.0)
    pobj, _ = problem_from_arrays(arrays, dtype=torch.float64, device="cpu")
    return jco, jb, blocks, ata, atb, SparseNormalBuilder(pobj.compile())


# ---------------------------------------------------------------------------
# sparse_block_solve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("whole", [False, True], ids=["levels", "whole"])
def test_sparse_block_solve_vjp_matches_jax(whole):
    _, jb, _, ata, atb, pb = _system()
    g = np.random.default_rng(0).standard_normal(np.shape(atb))
    _, vjp = jax.vjp(lambda a, b: jchol.sparse_block_solve(jb.sched, a, b), ata, atb)
    jd_ata, jd_atb = vjp(jnp.asarray(g))

    ata_t, atb_t = _t(ata, True), _t(atb, True)
    config.set_whole_sweep(whole)
    try:
        x = pchol.sparse_block_solve(pb.sched, ata_t, atb_t)
        d_ata, d_atb = torch.autograd.grad(x, (ata_t, atb_t), _t(g))
    finally:
        config.set_whole_sweep(False)
    _rel_close(x, jchol.sparse_block_solve(jb.sched, ata, atb), 1e-10)
    _rel_close(d_atb, jd_atb, 1e-10)
    _rel_close(d_ata, jd_ata, 1e-10)


def test_sparse_block_solve_backward_reuses_the_factor(monkeypatch):
    """The backward runs one solve with the saved factor and no
    factorization; d_ata is skipped when AtA needs no gradient."""
    _, _, _, ata, atb, pb = _system()
    ata_t, atb_t = _t(ata), _t(atb, True)
    x = pchol.sparse_block_solve(pb.sched, ata_t, atb_t)
    calls = []
    monkeypatch.setattr(pchol, "factorize", lambda *a: calls.append("factorize"))
    (d_atb,) = torch.autograd.grad(x.sum(), atb_t)
    assert calls == [] and bool(torch.isfinite(d_atb).all())


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------
def test_between_function_backward_matches_jax():
    rng = np.random.default_rng(1)
    K = 7

    def poses(scale):
        return np.asarray(jax.vmap(jax.vmap(jlie.se3.exp))(jnp.asarray(scale * rng.standard_normal((K, B, 6)))))

    v1, v2, meas = poses(1.0), poses(1.0), poses(0.5)
    cots = (rng.standard_normal((K, B, 6, 6)), rng.standard_normal((K, B, 6, 6)),
            rng.standard_normal((K, B, 6)))
    _, vjp = jax.vjp(_reference_linearize, jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(meas))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    args = [_t(a, True) for a in (v1, v2, meas)]
    outs = between_linearize(*args)
    got = torch.autograd.grad(outs, args, [_t(c) for c in cots])
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-12)


def test_assembly_function_backward_matches_jax():
    jco, jb, blocks, _, _, pb = _system()
    rng = np.random.default_rng(2)
    g_ata = rng.standard_normal((jb.pattern.n_slots, B, 6, 6))
    g_atb = rng.standard_normal((jb.pattern.n_vars, B, 6))
    _, vjp = jax.vjp(lambda bl: jasm._assemble_xla(jb.pattern, jco, bl), blocks)
    (jgrads,) = vjp((jnp.asarray(g_ata), jnp.asarray(g_atb)))
    pblocks = [([_t(j, True) for j in jacs], _t(err, True)) for jacs, err in blocks]
    flat = [t for jacs, err in pblocks for t in (*jacs, err)]
    ata, atb = assemble_blocks(pb.pattern, pblocks)
    got = torch.autograd.grad((ata, atb), flat, (_t(g_ata), _t(g_atb)))
    want = [t for jacs, err in jgrads for t in (*jacs, err)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-12)


# ---------------------------------------------------------------------------
# Lie exp / log gradients
# ---------------------------------------------------------------------------
def _lie_cases():
    rng = np.random.default_rng(3)
    se3_x = np.concatenate([rng.standard_normal((5, 6)), np.zeros((2, 6))])
    so3_w = np.concatenate([rng.standard_normal((5, 3)), np.zeros((2, 3))])
    se3_g = np.asarray(jax.vmap(jlie.se3.exp)(jnp.asarray(se3_x)))
    so3_g = np.asarray(jax.vmap(jlie.so3.exp)(jnp.asarray(so3_w)))
    return {
        "se3_exp": (se3.exp, jlie.se3.exp, se3_x),
        "se3_log": (se3.log, jlie.se3.log, se3_g),
        "so3_exp": (so3.exp, jlie.so3.exp, so3_w),
        "so3_log": (so3.log, jlie.so3.log, so3_g),
    }


@pytest.mark.parametrize("op", ["se3_exp", "se3_log", "so3_exp", "so3_log"])
def test_lie_gradients_match_jax_including_zero(op):
    """Rows 5-6 of each input are exactly zero tangents (identity elements)."""
    port_fn, jax_fn, x = _lie_cases()[op]
    out_shape = np.shape(jax.vmap(jax_fn)(jnp.asarray(x)))
    cot = np.random.default_rng(4).standard_normal(out_shape)
    _, vjp = jax.vjp(jax.vmap(jax_fn), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(cot))
    xt = _t(x, True)
    (got,) = torch.autograd.grad(port_fn(xt), xt, _t(cot))
    assert bool(torch.isfinite(got).all())
    _rel_close(got, want, 1e-12)


# ---------------------------------------------------------------------------
# the outer gradient of the flagship training step
# ---------------------------------------------------------------------------
THETA = 1.3
SOLVERS = {"implicit": ("lm", 30), "unroll": ("gn", 6), "truncated": ("gn", 6)}
RTOL = {"implicit": 1e-6, "unroll": 1e-9, "truncated": 1e-9}


@functools.lru_cache(maxsize=None)
def _jax_outer(mode):
    """(loss, d loss / d theta) of the JAX package's training step, built as
    its __graft_entry__ builds it: theta scales the loop-closure weights."""
    gt, edges, meas, init = _arrays()
    w_odo = jt.ScaleCostWeight(jt.Variable(jnp.ones((1, 1)), name="w_odo"))
    w_loop = jt.ScaleCostWeight(jt.Variable(jnp.ones((1, 1)), name="w_loop"))
    obj = jt.Objective(dtype=jnp.float64)
    poses = [jt.SE3(name=f"pose_{i}") for i in range(N)]
    obj.add(JLocal(poses[0], gt[0], jt.ScaleCostWeight(jnp.asarray(10.0)), name="prior"))
    for ei, (i, j) in enumerate(edges):
        obj.add(JBetween(poses[i], poses[j], meas[ei], cost_weight=w_odo if ei < N - 1 else w_loop,
                         name=f"edge_{ei}"))
    kind, iters = SOLVERS[mode]
    opt = (jt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True) if kind == "lm"
           else jt.GaussNewton(obj, max_iterations=iters))
    layer = jt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values({f"pose_{i}": init[i] for i in range(N)})
    state, aux = co.pack(values, B), co.build_aux(values, B)
    bi = next(i for i, bk in enumerate(co.buckets) if isinstance(bk.template, JBetween))
    loop = jnp.asarray([n == "w_loop" for n in co.buckets[bi].weight_slots[0].names])

    def loss(theta):
        a = list(aux)
        cf, wa = a[bi]
        a[bi] = (cf, tuple(w * jnp.where(loop[:, None, None], theta, 1.0) for w in wa))
        carry = layer.solve_state(state, tuple(a), mode, opt.opts, 2)
        d = jax.vmap(jax.vmap(jlie.SE3.local))(carry["state"]["SE3"], jnp.asarray(gt))
        return jnp.mean(jnp.sum(d * d, -1))

    value, grad = jax.value_and_grad(loss)(jnp.asarray(THETA))
    return float(value), float(grad)


def _port_outer(mode):
    gt, edges, meas, init = _arrays()
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(N, edges, meas, gt[0], dtype=torch.float64, device="cpu",
                                 edge_weight=w_odo, loop_weight=w_loop)
    kind, iters = SOLVERS[mode]
    opt = (tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization="sparse")
           if kind == "lm" else tt.GaussNewton(obj, max_iterations=iters, linearization="sparse"))
    theta = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    inputs = dict(pose_values(_t(init)), w_loop=theta.reshape(1, 1))
    out, _ = tt.TheseusLayer(opt).forward(
        inputs, optimizer_kwargs={"backward_mode": mode, "backward_num_iterations": 2})
    loss = mean_sq_local(out, _t(gt))
    loss.backward()
    return float(loss.detach()), float(theta.grad)


@pytest.mark.parametrize("whole", [False, True], ids=["levels", "whole"])
@pytest.mark.parametrize("mode", ["implicit", "unroll", "truncated"])
def test_outer_gradient_matches_jax(mode, whole):
    config.set_whole_sweep(whole)
    try:
        loss, grad = _port_outer(mode)
    finally:
        config.set_whole_sweep(False)
    jloss, jgrad = _jax_outer(mode)
    assert grad != 0.0
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    np.testing.assert_allclose(grad, jgrad, rtol=RTOL[mode])


def test_sgd_on_theta_lowers_the_loss():
    """Three SGD steps of the implicit training step on theta: the outer
    loss falls."""
    gt, edges, meas, init = _arrays()
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(N, edges, meas, gt[0], dtype=torch.float64, device="cpu",
                                 edge_weight=w_odo, loop_weight=w_loop)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=30, adaptive_damping=True,
                                                  linearization="sparse"))
    theta = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    sgd = torch.optim.SGD([theta], lr=20.0)
    losses = []
    for _ in range(3):
        sgd.zero_grad()
        out, _ = layer.forward(dict(pose_values(_t(init)), w_loop=theta.reshape(1, 1)),
                               optimizer_kwargs={"backward_mode": "implicit"})
        loss = mean_sq_local(out, _t(gt))
        loss.backward()
        sgd.step()
        losses.append(float(loss.detach()))
    assert losses[2] < losses[1] < losses[0]
