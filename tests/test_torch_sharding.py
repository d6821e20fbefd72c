"""Batch-axis sharding of theseus_tpu_torch (parallel/sharding.py) against the JAX package's, on the CPU, in float64.

The problem of tests/parallel/test_sharding.py (PGO, 8 poses, batch 8,
LM with adaptive damping, 5 iterations), built in both packages from the
JAX package's arrays. The JAX side runs on its 8 virtual CPU devices
(tests/conftest.py); the port's mesh is `make_mesh(devices=["cpu"] * 8)`,
eight shards of batch 1:

- the spec trees equal JAX's leaf for leaf, P(None, 'dp') -> dim 1,
  P('dp') -> dim 0, P() -> replicated;
- `shard_problem` raises when B does not divide; `make_mesh(n)` raises,
  naming the count, when fewer cards than n are present;
- the sharded solve (dense and sparse) against JAX's sharded solve (1e-10)
  and against the port's unsharded solve (1e-12); the merged iteration
  count "it" is the largest shard count, which is the unsharded solve's;
The outer gradients are in tests/test_torch_sharding_grad.py. The JAX
references are built once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.parallel import aux_pspecs as j_aux_pspecs
from theseus_tpu.parallel import carry_pspecs as j_carry_pspecs
from theseus_tpu.parallel import make_mesh as j_make_mesh
from theseus_tpu.parallel import shard_problem as j_shard_problem
from theseus_tpu.parallel import state_pspecs as j_state_pspecs
from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild
from theseus_tpu.utils.examples.pose_graph import pose_values as jpose_values
from theseus_tpu.utils.examples.pose_graph import synthetic_pose_graph as jsynthetic
import theseus_tpu_torch as tt
from theseus_tpu_torch.parallel import (aux_pspecs, carry_pspecs, make_mesh, shard_map_solve, shard_problem,
                                        state_pspecs)
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values

N_POSES, BATCH, ITERS = 8, 8, 5


@pytest.fixture(scope="module")
def arrays():
    gt, edges, meas, init = jsynthetic(n_poses=N_POSES, batch=BATCH, seed=3, dtype=jnp.float64)
    return {"gt": np.asarray(gt), "edges": [tuple(int(v) for v in e) for e in edges],
            "meas": np.asarray(meas), "init": np.asarray(init)}


def _jax_problem(a, linearization, iters=ITERS):
    obj, _ = jbuild(N_POSES, a["edges"], jnp.asarray(a["meas"]), jnp.asarray(a["gt"][0]), dtype=jnp.float64)
    opt = jt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization=linearization)
    layer = jt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values(jpose_values(jnp.asarray(a["init"])))
    return layer, co, co.pack(values, BATCH), co.build_aux(values, BATCH)


def _port_problem(a, linearization, iters=ITERS):
    obj, _ = build_pgo_objective(N_POSES, a["edges"], a["meas"], a["gt"][0], dtype=torch.float64, device="cpu")
    opt = tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization=linearization)
    layer = tt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values(pose_values(torch.as_tensor(a["init"])))
    return layer, co, co.pack(values, BATCH), co.build_aux(values, BATCH)


@pytest.fixture(scope="module")
def jax_ref(arrays):
    """JAX's sharded solves (dense, sparse) on the 8-device mesh and its
    spec trees."""
    mesh = j_make_mesh(8)
    out = {}
    for lin in ("dense", "sparse"):
        layer, co, state, aux = _jax_problem(arrays, lin)
        opts = layer.optimizer.opts
        solve = jax.jit(lambda s, x: layer.solve_state(s, x, "implicit", opts))
        sh_state, sh_aux = j_shard_problem(co, state, aux, mesh)
        with mesh:
            carry = solve(sh_state, sh_aux)
        out[lin] = jax.tree_util.tree_map(np.asarray, carry)
    layer, co, _, _ = _jax_problem(arrays, "dense")
    out["specs"] = (j_state_pspecs(co), j_aux_pspecs(co), j_carry_pspecs(co, out["dense"]))
    return out


def _dims(tree, axis):
    """Spec tree -> flat list of batch dims (None: replicated), in leaf order."""
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _dims(tree[k], axis)]
    if isinstance(tree, tuple) and not type(tree).__name__ in ("P", "PartitionSpec"):
        return [d for t in tree for d in _dims(t, axis)]
    return [tuple(tree).index(axis) if axis in tuple(tree) else None]


def test_pspecs_match_jax(arrays, jax_ref):
    layer, co, state, aux = _port_problem(arrays, "dense")
    carry = layer.solve_state(state, aux, "implicit", layer.optimizer.opts)
    j_state, j_aux, j_carry = jax_ref["specs"]
    assert _dims(state_pspecs(co), "dp") == _dims(j_state, "dp") == [1]
    assert _dims(aux_pspecs(co), "dp") == _dims(j_aux, "dp")
    assert set(carry) == set(j_carry)
    assert _dims(carry_pspecs(co, carry), "dp") == _dims(j_carry, "dp")
    assert carry_pspecs(co, carry)["it"] == ()


def test_shard_problem_raises_when_batch_does_not_divide(arrays):
    _, co, state, aux = _port_problem(arrays, "dense")
    with pytest.raises(ValueError, match="does not divide"):
        shard_problem(co, state, aux, make_mesh(devices=["cpu"] * 3))


def test_make_mesh_counts_the_cards():
    assert len(make_mesh(devices=["cpu"] * 8)) == 8
    assert len(make_mesh(4, devices=["cpu"] * 8)) == 4
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs {n + 1} CUDA devices but {n} are present"):
        make_mesh(n + 1)


@pytest.mark.parametrize("linearization", ["dense", "sparse"])
def test_sharded_solve_matches_jax(arrays, jax_ref, linearization):
    layer, co, state, aux = _port_problem(arrays, linearization)
    opts = layer.optimizer.opts
    ref = layer.solve_state(state, aux, "implicit", opts)
    mesh = make_mesh(devices=["cpu"] * 8)
    states, auxes = shard_problem(co, state, aux, mesh)
    assert [s["SE3"].shape[1] for s in states] == [1] * 8
    out = shard_map_solve(layer, mesh, "implicit")(states, auxes)
    want = jax_ref[linearization]
    np.testing.assert_allclose(out["state"]["SE3"].numpy(), want["state"]["SE3"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(out["err"].numpy(), want["err"], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(out["state"]["SE3"].numpy(), ref["state"]["SE3"].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["history"].numpy(), ref["history"].numpy(), rtol=1e-12, atol=1e-15)
    for k in ("done", "fail", "converged_iter"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k].numpy())
    # "it": the largest shard count, the unsharded early-exit solve's
    shard_its = [layer.solve_state(s, x, "implicit", opts)["it"] for s, x in zip(states, auxes)]
    assert out["it"] == max(shard_its) == ref["it"]


def test_sharded_solve_splits_the_ignore_mask(arrays):
    """A batch_ignore_mask is split with the batch: the frozen elements keep
    their input state, the rest equal the unsharded masked solve (1e-12)."""
    layer, co, state, aux = _port_problem(arrays, "dense")
    mask = torch.tensor([True, False, False, True, False, False, False, True])
    ref = layer.solve_state(state, aux, "implicit", layer.optimizer.opts, batch_ignore_mask=mask)
    mesh = make_mesh(devices=["cpu"] * 4)
    out = shard_map_solve(layer, mesh, "implicit", batch_ignore_mask=mask)(*shard_problem(co, state, aux, mesh))
    np.testing.assert_allclose(out["state"]["SE3"].numpy(), ref["state"]["SE3"].numpy(), rtol=0, atol=1e-12)
    assert torch.equal(out["state"]["SE3"][:, mask], state["SE3"][:, mask])
    assert torch.equal(out["ignore"], mask)
