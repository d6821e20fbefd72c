"""Manifold first-order updates of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `manifold_update` (SE3, SO3, SE2) against JAX's on the same element and
  Euclidean gradient: 1e-12.
- `lie_optimizer` over torch's Adam against `lie_optimizer` over
  optax.adam, and over torch's SGD with momentum against optax.sgd: ten
  steps on {"pose": SE3 (B, 3, 4), "w": (B, 3)} minimizing a smooth loss
  of both, each step's gradient from the package's own autodiff; the
  whole trajectory of both leaves agrees, 1e-9 (the two Adam updates are
  the same formula, rounded differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from theseus_tpu.lie import group as jgroup
from theseus_tpu.optim.manifold_optax import lie_optimizer as jlie_optimizer
from theseus_tpu.optim.manifold_optax import manifold_update as jmanifold_update
from theseus_tpu_torch.lie import group as tgroup
from theseus_tpu_torch.optim import lie_optimizer, manifold_update


def _elements(name, n=3, seed=0):
    g = tgroup.by_name(name)
    gen = torch.Generator().manual_seed(seed)
    return g, g.randn(n, generator=gen, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["SE3", "SO3", "SE2"])
def test_manifold_update_matches_jax(name):
    g, x = _elements(name)
    egrad = np.random.default_rng(1).standard_normal(tuple(x.shape))
    want = jmanifold_update(getattr(jgroup, name), jnp.asarray(x.numpy()), jnp.asarray(egrad), 0.1)
    got = manifold_update(g, x, torch.as_tensor(egrad), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def _loss(m, target, params):
    """Squared distance of the pose's matrix to a target plus a quadratic
    in w coupled to the pose's translation."""
    p, w = params["pose"], params["w"]
    return m.sum((p - target) ** 2) + m.sum((w - 0.5 * p[..., :, 3]) ** 2) + 0.1 * m.sum(w ** 4)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_lie_optimizer_trajectory_matches_optax(kind):
    _, pose = _elements("SE3", n=2, seed=3)
    _, target = _elements("SE3", n=2, seed=4)
    w0 = np.random.default_rng(5).standard_normal((2, 3))
    target_np = target.numpy()

    if kind == "adam":
        jtx = jlie_optimizer({"pose": jgroup.SE3}, optax.adam(0.05))
        tx = lie_optimizer({"pose": tgroup.SE3}, lambda ps: torch.optim.Adam(ps, lr=0.05))
    else:
        jtx = jlie_optimizer({"pose": jgroup.SE3}, optax.sgd(0.05, momentum=0.9))
        tx = lie_optimizer({"pose": tgroup.SE3}, lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9))

    jparams = {"pose": jnp.asarray(pose.numpy()), "w": jnp.asarray(w0)}
    jstate = jtx.init(jparams)
    jgrad = jax.grad(lambda p: _loss(jnp, jnp.asarray(target_np), p))
    params = {"pose": pose.clone(), "w": torch.as_tensor(w0)}
    state = tx.init(params)
    for _ in range(10):
        jupd, jstate = jtx.update(jgrad(jparams), jstate, jparams)
        jparams = jtx.apply(jparams, jupd)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(_loss(torch, target, leaves), list(leaves.values()))))
        upd, state = tx.update(grads, state, params)
        params = tx.apply(params, upd)
        for k in params:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-9)
    # the pose stays on the manifold and the loss went down
    r = params["pose"][..., :3]
    np.testing.assert_allclose((r.mT @ r).numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)), atol=1e-10)
    assert float(_loss(torch, target, params)) < float(_loss(torch, target, {"pose": pose, "w": torch.as_tensor(w0)}))
