"""GBP under sharding in theseus_tpu_torch (parallel/sharding.py) against the JAX package, on the CPU, in float64.

- Factor sharding, the problem of tests/parallel/test_gbp_problem_sharding.py:
  32 SE3 poses at batch 2, the chain plus one closure (32 Between factors,
  split over `make_mesh(devices=["cpu"] * 8, axis="factors")`; the prior,
  K = 1, stays whole on the home device), 15 sweeps at message damping
  0.3, LM damping 1e-3. The sharded delta against JAX's delta on the same
  arrays: 1e-9 (the JAX test's tolerance between its sharded and
  unsharded solves), with more than 0 cross-device belief sums; `Atb`,
  `diag`, `quad` and `marginals` of the sharded normal against the
  unsharded port's: 1e-12 of the largest entry.
- Batch sharding, the problem of tests/parallel/test_gbp_sharding.py (an
  SE2 chain of 6 poses with a loop closure at batch 8, 8 outer iterations
  of 25 sweeps at message damping 0.3) in float64: the port's
  `shard_map_solve` over eight CPU shards against JAX's batch-sharded
  solve on its 8 virtual devices: 1e-8.

The JAX references are built once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.lie import se2 as jse2
from theseus_tpu.lie import se3 as jse3
from theseus_tpu.optim.gbp import GBPNormal as JGBPNormal
from theseus_tpu.optim.gbp import GBPNormalBuilder as JGBPNormalBuilder
from theseus_tpu.parallel import make_mesh as j_make_mesh
from theseus_tpu.parallel import shard_problem as j_shard_problem
from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild
from theseus_tpu.utils.examples.pose_graph import pose_values as jpose_values
from theseus_tpu.utils.examples.pose_graph import synthetic_pose_graph as jsynthetic
import theseus_tpu_torch as tt
from theseus_tpu_torch.lie import se2
from theseus_tpu_torch.optim.gbp import GBPNormal, GBPNormalBuilder
from theseus_tpu_torch.parallel import make_mesh, shard_gbp_factors, shard_map_solve, shard_problem
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values

N_POSES, BATCH, SWEEPS, MSG_DAMPING, LM_DAMPING = 32, 2, 15, 0.3, 1e-3


@pytest.fixture(scope="module")
def factor_problem():
    """The arrays of the 32-pose problem and JAX's unsharded delta."""
    gt, edges, meas, init = jsynthetic(n_poses=N_POSES, batch=BATCH, seed=0, dtype=jnp.float64,
                                       extra_loop_closures=False)
    edges = [tuple(int(v) for v in e) for e in edges] + [(0, N_POSES // 2)]
    closure = jse3.compose(jse3.inverse(gt[0]), gt[N_POSES // 2])
    meas = jnp.concatenate([meas, closure[None]], axis=0)
    obj, _ = jbuild(N_POSES, edges, meas, gt[0], dtype=jnp.float64)
    co = obj.compile()
    values = obj.default_values(jpose_values(init))
    bld = JGBPNormalBuilder(co, msg_iters=SWEEPS, msg_damping=MSG_DAMPING)
    normal = bld.build(co.pack(values, BATCH), co.build_aux(values, BATCH))

    @jax.jit
    def solve(lams, etas):
        return JGBPNormal(bld, lams, etas, normal.dtype, normal.bsz).solve(damping=LM_DAMPING)[0]

    return {"gt": np.asarray(gt), "edges": edges, "meas": np.asarray(meas), "init": np.asarray(init),
            "delta": np.asarray(solve(normal.lams, normal.etas))}


def _port_normal(a):
    obj, _ = build_pgo_objective(N_POSES, a["edges"], a["meas"], a["gt"][0], dtype=torch.float64, device="cpu")
    co = obj.compile()
    values = obj.default_values(pose_values(torch.as_tensor(a["init"])))
    bld = GBPNormalBuilder(co, msg_iters=SWEEPS, msg_damping=MSG_DAMPING)
    return bld.build(co.pack(values, BATCH), co.build_aux(values, BATCH))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def test_gbp_factor_sharded_delta_matches_jax(factor_problem):
    normal = _port_normal(factor_problem)
    mesh = make_mesh(devices=["cpu"] * 8, axis="factors")
    sharded = shard_gbp_factors(normal, mesh)
    # the Between bucket (K = 32) is split into 8 chunks of 4, the prior (K = 1) whole
    ks = sorted(e[0].shape[0] for e in sharded.etas)
    assert ks == [1] + [4] * 8, ks
    assert sorted(slot for _, slot, _, _ in sharded.chunks) == [0] * 2 + list(range(1, 8))
    delta, fail = sharded.solve(LM_DAMPING)
    assert not bool(fail.any())
    assert sharded.cross_device_sums > 0, "factor axis silently left whole"
    # two reductions (eta, lam) a belief, SWEEPS sweeps and the final beliefs
    assert sharded.cross_device_sums == 2 * (SWEEPS + 1)
    _close(delta.numpy(), factor_problem["delta"], 1e-9)
    np.testing.assert_allclose(delta.numpy(), factor_problem["delta"], rtol=1e-9, atol=1e-12)
    want, _ = normal.solve(LM_DAMPING)
    _close(delta.numpy(), want.numpy(), 1e-12)


def test_gbp_factor_sharded_normal_protocol(factor_problem):
    normal = _port_normal(factor_problem)
    sharded = shard_gbp_factors(normal, make_mesh(devices=["cpu"] * 8, axis="factors"))
    _close(sharded.Atb.numpy(), normal.Atb.numpy(), 1e-12)
    _close(sharded.diag().numpy(), normal.diag().numpy(), 1e-12)
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(normal.Atb.shape)))
    _close(sharded.quad(v).numpy(), normal.quad(v).numpy(), 1e-12)
    mean_s, lam_s = sharded.marginals(LM_DAMPING)
    mean_u, lam_u = normal.marginals(LM_DAMPING)
    _close(mean_s.numpy(), mean_u.numpy(), 1e-12)
    _close(lam_s.numpy(), lam_u.numpy(), 1e-12)


@pytest.mark.parametrize("ids", [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [0, 1, 2, 3], [7, 7, 7]])
def test_scatter_plan_adds_each_variable_once_a_call(ids):
    """Each index_add of a plan meets a variable at most once, the rounds
    take a variable's factors in K order, and together they add every row
    once: the sum equals one index_add over all rows."""
    from theseus_tpu_torch.optim.gbp import _scatter_plan

    g = np.asarray(ids)
    plan = _scatter_plan(g, "cpu")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((len(g), 2, 3)))
    acc, seen_rows = torch.zeros((10, 2, 3), dtype=x.dtype), []
    for rows, gv in plan:
        assert len(set(gv.tolist())) == len(gv)
        r = torch.arange(len(g)) if rows is None else rows
        assert gv.tolist() == g[r.numpy()].tolist()
        seen_rows += r.tolist()
        acc = acc.index_add(0, gv, x if rows is None else x[rows])
    assert sorted(seen_rows) == list(range(len(g)))
    assert (len(plan) == 1) == (len(set(ids)) == len(ids))
    for v in set(ids):  # a variable's rows in K order across the rounds
        order = [r for rows, _ in plan for r in ((range(len(g))) if rows is None else rows.tolist()) if g[r] == v]
        assert order == sorted(order)
    torch.testing.assert_close(acc, torch.zeros_like(acc).index_add(0, torch.as_tensor(g), x), rtol=0, atol=1e-14)


def test_gbp_factor_sharded_equals_unsharded_bits(factor_problem):
    """The belief sums add in the unsharded order wherever at most two terms
    of a variable meet across chunks. At 8 shards of 4 the closure's three
    terms at pose 16 lie in three chunks, so the delta has the unsharded
    bits; at 2 shards pose 16's terms group otherwise: within 1e-5 relative
    in float32."""
    normal = _port_normal(factor_problem)
    want, _ = normal.solve(LM_DAMPING)
    again, _ = normal.solve(LM_DAMPING)
    assert torch.equal(again, want)
    got, _ = shard_gbp_factors(normal, make_mesh(devices=["cpu"] * 8, axis="factors")).solve(LM_DAMPING)
    assert torch.equal(got, want)
    n32 = GBPNormalBuilder(normal.builder.co, msg_iters=SWEEPS, msg_damping=MSG_DAMPING)
    n32 = GBPNormal(n32, _cast(normal.lams), _cast(normal.etas), torch.float32, normal.bsz)
    want32, _ = n32.solve(LM_DAMPING)
    got32, _ = shard_gbp_factors(n32, make_mesh(devices=["cpu"] * 2, axis="factors")).solve(LM_DAMPING)
    assert float((got32 - want32).abs().max() / want32.abs().max()) <= 1e-5


def _cast(tree):
    """A (nested tuple) tree of float64 tensors in float32."""
    return tree.to(torch.float32) if isinstance(tree, torch.Tensor) else tuple(_cast(t) for t in tree)


def _se2_problem(m, batch=8, n=6, seed=0):
    """tests/parallel/test_gbp_sharding.py's problem in float64, in package m."""
    exp = jse2.exp if m is jt else se2.exp
    arr = jnp.asarray if m is jt else torch.as_tensor
    rng = np.random.default_rng(seed)
    gt_t, cur = [], np.zeros((batch, 3))
    for _ in range(n):
        gt_t.append(cur.copy())
        cur = cur + rng.normal(scale=0.4, size=(batch, 3))
    gt = [np.asarray(exp(arr(t))) for t in gt_t]
    obj = jt.Objective(dtype=jnp.float64) if m is jt else tt.Objective(dtype=torch.float64, device="cpu")
    poses = [m.SE2(tensor=np.asarray(exp(arr(gt_t[i] + rng.normal(scale=0.15, size=(batch, 3))))), name=f"x{i}")
             for i in range(n)]
    obj.add(m.Difference(poses[0], m.SE2(tensor=gt[0], name="prior_t"), m.ScaleCostWeight(10.0), name="prior"))
    compose = jse2.compose if m is jt else se2.compose
    inverse = jse2.inverse if m is jt else se2.inverse
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        meas = np.asarray(compose(inverse(arr(gt[i])), arr(gt[j])))
        obj.add(m.Between(poses[i], poses[j], m.SE2(tensor=meas, name=f"m{i}_{j}"), m.ScaleCostWeight(1.0),
                          name=f"e{i}_{j}"))
    layer = m.TheseusLayer(m.GaussianBeliefPropagation(obj, max_iterations=8, msg_iters=25, msg_damping=0.3))
    co = obj.compile()
    values = obj.default_values()
    b = co.resolve_batch_size(values)
    return layer, co, co.pack(values, b), co.build_aux(values, b)


@pytest.fixture(scope="module")
def jax_se2_carry():
    layer, co, state, aux = _se2_problem(jt)
    opts = layer.optimizer.opts
    mesh = j_make_mesh(8)
    sh_state, sh_aux = j_shard_problem(co, state, aux, mesh)
    with mesh:
        carry = jax.jit(lambda s, x: layer.solve_state(s, x, "implicit", opts))(sh_state, sh_aux)
    return jax.tree_util.tree_map(np.asarray, carry)


def test_gbp_batch_sharded_solve_matches_jax(jax_se2_carry):
    layer, co, state, aux = _se2_problem(tt)
    mesh = make_mesh(devices=["cpu"] * 8)
    out = shard_map_solve(layer, mesh, "implicit")(*shard_problem(co, state, aux, mesh))
    np.testing.assert_allclose(out["state"]["SE2"].numpy(), jax_se2_carry["state"]["SE2"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["err"].numpy(), jax_se2_carry["err"], rtol=1e-8, atol=1e-12)
    assert out["it"] == int(jax_se2_carry["it"])
