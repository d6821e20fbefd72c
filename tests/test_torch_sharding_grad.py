"""Outer gradients through the batch-sharded solve of theseus_tpu_torch against the JAX package's, on the CPU, in float64.

The problem of tests/test_torch_sharding.py (PGO, 8 poses, batch 8, dense
LM with adaptive damping), the port's mesh eight CPU shards of batch 1,
JAX's its 8 virtual CPU devices. The loss is the mean squared SE3 local
from the solution to the initial state; gradients with respect to every
aux leaf (measurements, prior target, weights), which reach each shard's
aux through `shard_problem`'s slices and the carries' join:

- implicit (5 iterations) and unroll (3) against JAX's sharded gradients:
  1e-9;
- truncated (5 iterations, 2 differentiated) against the port's unsharded
  gradient: 1e-9 of the largest entry. The shards' dense products and
  factorizations run at batch 1 and round otherwise than at batch 8: the
  sharded gradients sit 2.5e-10 from the unsharded ones (entries up to
  3.5; 1.5e-10 in implicit mode) on this CPU.

The JAX references are built once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu import lie as jlie
from theseus_tpu.parallel import make_mesh as j_make_mesh
from theseus_tpu.parallel import shard_problem as j_shard_problem
from theseus_tpu_torch.lie import group as tgroup
from theseus_tpu_torch.parallel import make_mesh, shard_map_solve, shard_problem
from test_torch_sharding import ITERS, _jax_problem, _port_problem, arrays  # noqa: F401

SE3 = tgroup.by_name("SE3")


def _jax_loss(layer, mode, target):
    opts = layer.optimizer.opts

    def loss(state, aux):
        carry = layer.solve_state(state, aux, mode, opts)
        d = jax.vmap(jax.vmap(jlie.SE3.local))(carry["state"]["SE3"], target)
        return jnp.mean(jnp.sum(d * d, axis=-1))

    return loss


@pytest.fixture(scope="module")
def jax_grads(arrays):  # noqa: F811
    mesh = j_make_mesh(8)
    out = {}
    for mode, iters in (("implicit", ITERS), ("unroll", 3)):
        layer, co, state, aux = _jax_problem(arrays, "dense", iters)
        target = jax.lax.stop_gradient(state["SE3"])
        sh_state, sh_aux = j_shard_problem(co, state, aux, mesh)
        g = jax.jit(jax.grad(_jax_loss(layer, mode, target), argnums=1))
        with mesh:
            out[mode] = [np.asarray(x) for x in jax.tree_util.tree_leaves(g(sh_state, sh_aux))]
    return out


def _port_grad(arrays, mode, iters, sharded, bwd_iters=5):  # noqa: F811
    layer, co, state, aux = _port_problem(arrays, "dense", iters)
    opts = layer.optimizer.opts
    leaves = [t.detach().clone().requires_grad_(True) for b in aux for slots in b for t in slots]
    it = iter(leaves)
    aux = tuple(tuple(tuple(next(it) for _ in slots) for slots in b) for b in aux)
    target = state["SE3"].detach()
    if sharded:
        mesh = make_mesh(devices=["cpu"] * 8)
        states, auxes = shard_problem(co, state, aux, mesh)
        carry = shard_map_solve(layer, mesh, mode, opts, backward_num_iterations=bwd_iters)(states, auxes)
    else:
        carry = layer.solve_state(state, aux, mode, opts, bwd_iters)
    d = SE3.local(carry["state"]["SE3"], target)
    loss = torch.mean(torch.sum(d * d, dim=-1))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]


@pytest.mark.parametrize("mode,iters", [("implicit", ITERS), ("unroll", 3)])
def test_sharded_gradients_match_jax(arrays, jax_grads, mode, iters):  # noqa: F811
    got = _port_grad(arrays, mode, iters, sharded=True)
    want = jax_grads[mode]
    assert len(got) == len(want)
    assert any(float(np.abs(w).max()) > 1e-8 for w in want), "dead gradients"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9)


def test_sharded_truncated_gradient_matches_unsharded(arrays):  # noqa: F811
    got = _port_grad(arrays, "truncated", ITERS, sharded=True, bwd_iters=2)
    want = _port_grad(arrays, "truncated", ITERS, sharded=False, bwd_iters=2)
    scale = max(float(w.abs().max()) for w in want)
    assert scale > 1e-8, "dead gradients"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-9 * scale)
