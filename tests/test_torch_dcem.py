"""DCEM and the LML layer of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `lml`: forward (sum n, 0 < y < 1) and the closed-form adjoint against
  JAX's custom VJP on the same x and cotangent: 1e-12 and 1e-10.
- `CompiledObjective.flatten_raw` / `unflatten_raw` / `total_raw_dim` on an
  objective whose variables interleave three types (Vector(4), SE2,
  Vector(2)): equal to JAX's.
- `_cem_step` fed the noise of JAX's key (the soft LML elite, the softmax
  at n_elite 1, the hard top-k at temp None): 1e-10.
- a whole DCEM solve (soft and hard) fed the JAX key chain's draws
  (`_draw_noise` patched): solution, error history and status against
  JAX's `solve` with that key, 1e-8.
- the unroll and truncated gradients of a loss on the solution with
  respect to a scale on the targets, the same way: 1e-7.
- the layer rejects implicit and dlm; `optimize` with a seeded generator
  reaches the targets of tests/optim/test_extras.py (atol 0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.lie import se2 as jse2
from theseus_tpu.optim.dcem import DCEM as JDCEM
from theseus_tpu.optim.lml import lml as jlml
import theseus_tpu_torch as tt
from theseus_tpu_torch.lie import se2
from theseus_tpu_torch.optim import DCEM, lml

B = 3


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, size=(B, 4)), rng.uniform(-1, 1, size=(B, 2)),
            se2.exp(torch.as_tensor(rng.uniform(-0.5, 0.5, size=(B, 3)))).numpy())


def _objective(m, t4, t2, tp):
    """x (Vector 4), p (SE2), y (Vector 2) in that order, one cost each."""
    x, p, y = m.Vector(4, name="x"), m.SE2(name="p"), m.Vector(2, name="y")
    if m is jt:
        obj = jt.Objective(dtype=jnp.float64)
    else:
        obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(m.AutoDiffCostFunction([x], 4, lambda o, a: o[0] - a[0], aux_vars=[m.Variable(t4, name="t4")],
                                   name="cx"))
    obj.add(m.Difference(p, m.SE2(tensor=tp, name="tp"), m.ScaleCostWeight(2.0), name="cp"))
    obj.add(m.AutoDiffCostFunction([y], 2, lambda o, a: 3.0 * (o[0] - a[0]), aux_vars=[m.Variable(t2, name="t2")],
                                   name="cy"))
    return obj


def _init(seed=1):
    rng = np.random.RandomState(seed)
    p0 = se2.exp(torch.as_tensor(rng.uniform(-0.3, 0.3, size=(B, 3)))).numpy()
    return {"x": rng.randn(B, 4) * 0.5, "p": p0, "y": rng.randn(B, 2) * 0.5}


def _pair(theta=1.0):
    t4, t2, tp = _data()
    jobj, obj = _objective(jt, t4, t2, tp), _objective(tt, t4, t2, tp)
    init = _init()
    jv = jobj.default_values({**{k: jnp.asarray(v) for k, v in init.items()}, "t4": jnp.asarray(theta * t4)})
    return jobj, obj, jv, init, t4


def _noise_chain(key, n, shape):
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, dtype=jnp.float64)))
    return out


def _feed(monkeypatch, draws):
    it = iter(draws)
    monkeypatch.setattr(DCEM, "_draw_noise", lambda self, gen, shape, dtype, device: torch.as_tensor(next(it)))


def test_lml_forward_and_adjoint_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 20)) * 2.0
    g = rng.standard_normal(x.shape)
    want, vjp = jax.vjp(lambda a: jlml(a, 5), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    tx = torch.as_tensor(x).requires_grad_(True)
    y = lml(tx, 5)
    (got_g,) = torch.autograd.grad(y, tx, torch.as_tensor(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.detach().sum(-1).numpy(), 5.0, atol=1e-9)
    assert float(y.min()) > 0 and float(y.max()) < 1
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lml(torch.as_tensor(x), 25).numpy(), 1.0)


def test_raw_flattening_matches_jax():
    jobj, obj, jv, init, _ = _pair()
    jco, co = jobj.compile(), obj.compile()
    v = obj.default_values(init)
    assert co.total_raw_dim == jco.total_raw_dim == 10
    want = np.asarray(jco.flatten_raw(jco.pack(jv, B)))
    got = co.flatten_raw(co.pack(v, B))
    np.testing.assert_array_equal(got.numpy(), want)
    back = co.unflatten_raw(got)
    jback = jco.unflatten_raw(jnp.asarray(want))
    assert set(back) == set(jback)
    for tk in back:
        np.testing.assert_array_equal(back[tk].numpy(), np.asarray(jback[tk]))


@pytest.mark.parametrize("kw", [dict(), dict(n_elite=1), dict(temp=None)], ids=["lml", "softmax", "hard"])
def test_cem_step_matches_jax(kw):
    jobj, obj, jv, init, _ = _pair()
    jco, co = jobj.compile(), obj.compile()
    jopt, opt = JDCEM(jobj, n_sample=30, **kw), DCEM(obj, n_sample=30, **kw)
    v = obj.default_values(init)
    jmu = jco.flatten_raw(jco.pack(jv, B))
    jsig = jnp.full_like(jmu, 0.7)
    key = jax.random.PRNGKey(11)
    jnew = jopt._cem_step(jco, jmu, jsig, jco.build_aux(jv, B), key, jopt.opts)
    noise = np.asarray(jax.random.normal(key, (30, B, 10), dtype=jnp.float64))
    new = opt._cem_step(co, co.flatten_raw(co.pack(v, B)), torch.full((B, 10), 0.7, dtype=torch.float64),
                        co.build_aux(v, B), torch.as_tensor(noise), opt.opts)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


@pytest.mark.parametrize("kw", [dict(), dict(temp=None, n_elite=6)], ids=["lml", "hard"])
def test_dcem_solve_matches_jax_key_chain(monkeypatch, kw):
    jobj, obj, jv, init, _ = _pair()
    jco, co = jobj.compile(), obj.compile()
    iters = 12
    jopt = JDCEM(jobj, max_iterations=iters, n_sample=40, **kw)
    opt = DCEM(obj, max_iterations=iters, n_sample=40, **kw)
    key = jax.random.PRNGKey(5)
    jcarry = jopt.solve(jco.pack(jv, B), jco.build_aux(jv, B), key)
    _feed(monkeypatch, _noise_chain(key, iters, (40, B, 10)))
    v = obj.default_values(init)
    carry = opt.solve(co.pack(v, B), co.build_aux(v, B))
    for tk in carry["state"]:
        np.testing.assert_allclose(carry["state"][tk].numpy(), np.asarray(jcarry["state"][tk]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry["history"].numpy(), np.asarray(jcarry["history"]), rtol=1e-8, atol=1e-12)
    jinfo, info = jopt.make_info(jcarry, jopt.opts), opt.make_info(carry, opt.opts)
    np.testing.assert_array_equal(info.status.numpy(), np.asarray(jinfo.status))
    np.testing.assert_array_equal(info.converged_iter.numpy(), np.asarray(jinfo.converged_iter))


@pytest.mark.parametrize("mode", ["unroll", "truncated"])
def test_dcem_gradients_match_jax(monkeypatch, mode):
    t4, t2, tp = _data()
    jobj, obj = _objective(jt, t4, t2, tp), _objective(tt, t4, t2, tp)
    jco, co = jobj.compile(), obj.compile()
    init = _init()
    iters, s = 8, 30
    key = jax.random.PRNGKey(2)
    jopt = JDCEM(jobj, max_iterations=iters, n_sample=s, key=key)
    jlayer = jt.TheseusLayer(jopt)

    def jloss(theta):
        vals = jobj.default_values({**{k: jnp.asarray(v) for k, v in init.items()}, "t4": theta * jnp.asarray(t4)})
        carry = jlayer.solve_state(jco.pack(vals, B), jco.build_aux(vals, B), mode, jopt.opts,
                                   backward_num_iterations=3)
        sol = jco.unpack(carry["state"])
        return jnp.sum(sol["x"] ** 2) + jnp.sum(sol["y"])

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(1.2, jnp.float64))

    _feed(monkeypatch, _noise_chain(key, iters, (s, B, 10)))
    opt = DCEM(obj, max_iterations=iters, n_sample=s)
    layer = tt.TheseusLayer(opt)
    theta = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    vals = obj.default_values({**init, "t4": theta * torch.as_tensor(t4)})
    carry = layer.solve_state(co.pack(vals, B), co.build_aux(vals, B), mode, opt.opts, 3)
    sol = co.unpack(carry["state"])
    loss = torch.sum(sol["x"] ** 2) + torch.sum(sol["y"])
    (g,) = torch.autograd.grad(loss, theta)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-8)
    np.testing.assert_allclose(float(g), float(want_g), rtol=1e-7, atol=1e-12)
    assert abs(float(g)) > 1e-3


@pytest.mark.parametrize("mode", ["implicit", "dlm"])
def test_dcem_rejects_gradient_modes(mode):
    _, obj, _, init, _ = _pair()
    layer = tt.TheseusLayer(DCEM(obj, max_iterations=5))
    with pytest.raises(ValueError, match="supports backward modes"):
        layer.forward(init, optimizer_kwargs={"backward_mode": mode})


@pytest.mark.parametrize("temp", [1.0, None])
def test_dcem_optimize_reaches_targets(temp):
    _, obj, _, init, t4 = _pair()
    gen = torch.Generator().manual_seed(3)
    opt = DCEM(obj, max_iterations=40, n_sample=120, n_elite=8, temp=temp, generator=gen)
    values, info = opt.optimize(input_tensors=init)
    np.testing.assert_allclose(values["x"].numpy(), t4, atol=0.05)
    assert info.err_history.shape == (41, B)
