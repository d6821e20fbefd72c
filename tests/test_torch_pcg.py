"""Block-Jacobi PCG of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The PGO problems of tests/optim/test_pcg.py (the JAX package's synthetic
graph, carried across by utils/convert.py):

- `block_matvec` on the JAX package's assembled AtA: 1e-12;
- `pcg_block_solve` forward (100 iterations) and both cotangents (the AtA
  slots' and b's) against JAX's custom VJP on the same AtA, b and
  cotangent: 1e-9 relative to the largest entry;
- the PCG delta against the direct (block Cholesky) delta, undamped and
  damped, at pcg_iters=200: rtol 1e-6, atol 1e-8 (the JAX test's);
- `GaussNewton(obj, linearization="sparse", sparse_solver="pcg",
  pcg_iters=150)` inside an implicit layer solve whose aux is scaled by
  theta: the solution and d(sum x^2)/d theta against the JAX package's
  PCG run and against the port's direct solve, atol 1e-4 and rtol 1e-3
  (the JAX test's). 150 iterations leave this system's CG short of
  convergence (1.1e-5 from the direct solution), and there the last bits
  of rounding move an unconverged CG's iterate: the two packages' PCG
  solutions differ by 1.8e-5, as they do when the port runs the JAX
  package's two triangular solves an iteration (3.5e-5); the direct
  solves agree to 8.5e-10;
- a bad `sparse_solver` raises; the covariances of a PCG optimizer take
  the dense path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.optim.normal import SparseNormalBuilder as JSparseNormalBuilder
from theseus_tpu.sparse import pcg as jpcg
from theseus_tpu.utils.examples.pose_graph import (
    build_pgo_objective as jbuild_pgo,
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic_pgo,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse import pcg
from theseus_tpu_torch.utils.convert import problem_from_arrays


@functools.lru_cache(maxsize=None)
def _arrays(n, batch):
    gt, edges, meas, init = jsynthetic_pgo(n_poses=n, batch=batch, dtype=jnp.float64)
    return dict(gt=np.array(gt), edges=np.array(edges), measurements=np.array(meas), init=np.array(init),
                prior_weight=10.0)


def _pair(n=12, batch=2):
    a = _arrays(n, batch)
    edges = [tuple(int(v) for v in e) for e in a["edges"]]
    jobj, _ = jbuild_pgo(n, edges, jnp.asarray(a["measurements"]), jnp.asarray(a["gt"][0]), dtype=jnp.float64)
    obj, inputs = problem_from_arrays(a, dtype=torch.float64, device="cpu")
    return (jobj, jpose_values(jnp.asarray(a["init"]))), (obj, inputs)


def _systems(n=12, batch=2, **kw):
    (jobj, jin), (obj, inputs) = _pair(n, batch)
    jco, co = jobj.compile(), obj.compile()
    jv, v = jobj.default_values(jin), obj.default_values(inputs)
    jns = JSparseNormalBuilder(jco, solver="pcg", **kw).build(jco.pack(jv, batch), jco.build_aux(jv, batch))
    bld = SparseNormalBuilder(co, solver="pcg", **kw)
    ns = bld.build(co.pack(v, batch), co.build_aux(v, batch))
    return jns, ns, bld


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def test_block_matvec_matches_jax():
    jns, ns, bld = _systems()
    _close(ns.ata.numpy(), jns.ata, 1e-12)
    x = np.random.default_rng(0).standard_normal((bld.pattern.n_vars, 2, bld.pattern.d))
    want = jpcg.block_matvec(jns.builder.pcg_sched, jns.ata, jnp.asarray(x))
    got = pcg.block_matvec(bld.pcg_sched, torch.as_tensor(np.array(jns.ata)), torch.as_tensor(x))
    _close(got.numpy(), want, 1e-12)


def test_pcg_block_solve_forward_and_cotangents_match_jax():
    jns, ns, bld = _systems()
    rng = np.random.default_rng(1)
    ata = np.asarray(jns.ata)
    b = rng.standard_normal((bld.pattern.n_vars, 2, bld.pattern.d))
    g = rng.standard_normal(b.shape)
    jsched = jns.builder.pcg_sched
    want, vjp = jax.vjp(lambda a, r: jpcg.pcg_block_solve(jsched, a, r, 100, 1e-10), jnp.asarray(ata), jnp.asarray(b))
    want_ata, want_b = vjp(jnp.asarray(g))
    ta = torch.as_tensor(ata).requires_grad_(True)
    tb = torch.as_tensor(b).requires_grad_(True)
    got = pcg.pcg_block_solve(bld.pcg_sched, ta, tb, 100, 1e-10)
    got_ata, got_b = torch.autograd.grad(got, [ta, tb], torch.as_tensor(g))
    _close(got.detach().numpy(), want, 1e-9)
    _close(got_b.numpy(), want_b, 1e-9)
    _close(got_ata.numpy(), want_ata, 1e-9)
    assert float(got_ata[0].abs().max()) == 0.0  # the padding slot


def test_pcg_delta_matches_direct():
    (_, _), (obj, inputs) = _pair()
    co = obj.compile()
    v = obj.default_values(inputs)
    state, aux = co.pack(v, 2), co.build_aux(v, 2)
    ns_d = SparseNormalBuilder(co).build(state, aux)
    ns_p = SparseNormalBuilder(co, solver="pcg", pcg_iters=200).build(state, aux)
    for damping in (0.0, 1e-2):
        dd, _ = ns_d.solve(damping, False)
        dp, _ = ns_p.solve(damping, False)
        np.testing.assert_allclose(dp.numpy(), dd.numpy(), rtol=1e-6, atol=1e-8)


def _jax_solve(jobj, jin, solver):
    jco = jobj.compile()
    values = jobj.default_values(jin)
    state = jco.pack(values, 1)
    opt = jt.GaussNewton(jobj, max_iterations=6, linearization="sparse", sparse_solver=solver, pcg_iters=150)
    layer = jt.TheseusLayer(opt)

    def f(theta):
        aux = jax.tree_util.tree_map(lambda a: a * theta, jco.build_aux(values, 1))
        carry = layer.solve_state(state, aux, "implicit", opt.opts)
        return jnp.sum(carry["state"]["SE3"] ** 2), carry["state"]["SE3"]

    # jitted: eager evaluation compiles every primitive of the solve alone
    (_, sol), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(1.1, jnp.float64))
    return np.asarray(sol), float(g)


def _torch_solve(obj, inputs, solver):
    co = obj.compile()
    values = obj.default_values(inputs)
    state = co.pack(values, 1)
    opt = tt.GaussNewton(obj, max_iterations=6, linearization="sparse", sparse_solver=solver, pcg_iters=150)
    layer = tt.TheseusLayer(opt)
    theta = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    aux = tuple(tuple(tuple(a * theta for a in slots) for slots in bucket) for bucket in co.build_aux(values, 1))
    carry = layer.solve_state(state, aux, "implicit", opt.opts)
    sol = carry["state"]["SE3"]
    (g,) = torch.autograd.grad(torch.sum(sol ** 2), theta)
    return sol.detach().numpy(), float(g)


def test_gauss_newton_pcg_matches_jax_and_direct():
    (jobj, jin), (obj, inputs) = _pair(n=8, batch=1)
    jsol, jg = _jax_solve(jobj, jin, "pcg")
    sol, g = _torch_solve(obj, inputs, "pcg")
    np.testing.assert_allclose(sol, jsol, atol=1e-4)
    np.testing.assert_allclose(g, jg, rtol=1e-3)
    dsol, dg = _torch_solve(obj, inputs, "direct")
    np.testing.assert_allclose(sol, dsol, atol=1e-4)
    np.testing.assert_allclose(g, dg, rtol=1e-3)


def test_pcg_options_and_covariances():
    (_, _), (obj, inputs) = _pair(n=6, batch=1)
    with pytest.raises(ValueError, match="sparse_solver"):
        _ = tt.GaussNewton(obj, linearization="sparse", sparse_solver="cg").normal_builder
    opt = tt.GaussNewton(obj, max_iterations=5, linearization="sparse", sparse_solver="pcg", pcg_iters=80)
    assert opt.normal_builder.pcg_iters == 80 and opt.normal_builder.sched is None
    out, _ = opt.optimize(input_tensors=inputs)
    got = tt.TheseusLayer(opt).compute_covariances(values=out, var_names=["pose_3"])
    want = tt.TheseusLayer(tt.GaussNewton(obj, linearization="sparse")).compute_covariances(
        values=out, var_names=["pose_3"])
    np.testing.assert_allclose(got["pose_3"].numpy(), want["pose_3"].numpy(), rtol=1e-8, atol=1e-10)
