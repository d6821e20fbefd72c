"""The DLM backward of theseus_tpu_torch (`backward_mode="dlm"`), on the CPU.

- The three properties of tests/core/test_dlm_perturbation.py on the port's
  groups: exact (to roundoff) on a linear least-squares problem over R^4;
  cotangent-scale invariance (an outer loss scaled by c gives c times the
  gradient, 1e-6); agreement with the implicit gradient on a manifold
  problem (SE3 here; the port has no SO3 group), 1e-5, the finite-difference
  level.
- The outer gradient of the flagship training step (PGO 16 poses x batch 4,
  the loop-closure weight theta) against `jax.grad` of the JAX layer's
  "dlm" mode, level and whole-sweep plans: 1e-9 relative (the same
  float64 arithmetic in another order).
- Frozen batch elements (batch_ignore_mask) contribute exactly zero.
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
from theseus_tpu.utils.examples.pose_graph import synthetic_pose_graph as jsynthetic
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.utils.examples.pose_graph import (
    build_pgo_objective,
    mean_sq_local,
    pose_values,
    training_weights,
)

N, B, GN_ITERS = 16, 4, 10
THETA = 1.3


# ---------------------------------------------------------------------------
# the perturbation properties
# ---------------------------------------------------------------------------
def _linear_grad(theta, loss_scale=1.0, n=4):
    """d/d theta of loss_scale * sum(x*^3), x* = argmin 0.5||x - t||^2 +
    0.5||0.7 x||^2 with t = (1..n) theta, through the DLM backward."""
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    x = tt.Vector(n, name="x")
    obj.add(tt.Local(x, tt.Variable(np.zeros((1, n)), name="target"), tt.ScaleCostWeight(1.0), name="fit"))
    obj.add(tt.Local(x, tt.Variable(np.zeros((1, n)), name="zero"), tt.ScaleCostWeight(0.7), name="reg"))
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=3, linearization="sparse"))
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    target = torch.arange(1.0, n + 1.0, dtype=torch.float64)[None] * th
    out, _ = layer.forward({"x": torch.zeros((1, n), dtype=torch.float64), "target": target},
                           optimizer_kwargs={"backward_mode": "dlm"})
    loss = loss_scale * torch.sum(out["x"] ** 3)
    (g,) = torch.autograd.grad(loss, th)
    return float(loss.detach()), float(g)


def test_dlm_exact_on_linear_problem():
    """x*(theta) is affine and one Gauss-Newton step solves the perturbed
    problem exactly, so central differences leave only roundoff."""
    _, g = _linear_grad(0.8)
    h = 1e-6
    fd = (_linear_grad(0.8 + h)[0] - _linear_grad(0.8 - h)[0]) / (2 * h)
    np.testing.assert_allclose(g, fd, rtol=1e-7)


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
def test_dlm_cotangent_scale_invariance(scale):
    """The normalized step makes the result exact in c."""
    np.testing.assert_allclose(_linear_grad(0.8, scale)[1], scale * _linear_grad(0.8)[1], rtol=1e-6)


def _se3_grad(mode, theta=0.4):
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    r = tt.SE3(name="r")
    obj.add(tt.Local(r, tt.Variable(se3.identity(1, dtype=torch.float64, device="cpu"), name="target"),
                     tt.ScaleCostWeight(1.0), name="fit"))
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=6, linearization="sparse"))
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    zero = torch.zeros((), dtype=torch.float64)
    # the JAX test's SO3 target, as a pure rotation of SE3
    target = se3.exp(torch.stack([zero, zero, zero, th, 0.3 + zero, 0.1 + zero])[None])
    out, _ = layer.forward({"r": se3.identity(1, dtype=torch.float64, device="cpu"), "target": target},
                           optimizer_kwargs={"backward_mode": mode})
    loss = torch.sum(out["r"] * torch.arange(12.0, dtype=torch.float64).reshape(3, 4))
    (g,) = torch.autograd.grad(loss, th)
    return float(g)


def test_dlm_matches_implicit_on_se3():
    g_dlm, g_imp = _se3_grad("dlm"), _se3_grad("implicit")
    assert g_imp != 0.0
    np.testing.assert_allclose(g_dlm, g_imp, rtol=1e-5)


# ---------------------------------------------------------------------------
# the flagship step against the JAX package
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _arrays():
    gt, edges, meas, init = jsynthetic(n_poses=N, batch=B, seed=0, dtype=jnp.float64)
    return np.array(gt), [tuple(map(int, e)) for e in edges], np.array(meas), np.array(init)


@functools.lru_cache(maxsize=None)
def _jax_dlm():
    """(loss, d loss / d theta) of the JAX layer's dlm step, theta scaling
    the loop-closure weights (the JAX package's training step)."""
    gt, edges, meas, init = _arrays()
    w_odo = jt.ScaleCostWeight(jt.Variable(jnp.ones((1, 1)), name="w_odo"))
    w_loop = jt.ScaleCostWeight(jt.Variable(jnp.ones((1, 1)), name="w_loop"))
    obj = jt.Objective(dtype=jnp.float64)
    poses = [jt.SE3(name=f"pose_{i}") for i in range(N)]
    obj.add(JLocal(poses[0], gt[0], jt.ScaleCostWeight(jnp.asarray(10.0)), name="prior"))
    for ei, (i, j) in enumerate(edges):
        obj.add(JBetween(poses[i], poses[j], meas[ei], cost_weight=w_odo if ei < N - 1 else w_loop,
                         name=f"edge_{ei}"))
    opt = jt.GaussNewton(obj, max_iterations=GN_ITERS)
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
        carry = layer.solve_state(state, tuple(a), "dlm", opt.opts)
        d = jax.vmap(jax.vmap(jlie.SE3.local))(carry["state"]["SE3"], jnp.asarray(gt))
        return jnp.mean(jnp.sum(d * d, -1))

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(THETA))
    return float(value), float(grad)


def _port_dlm(mask=None, loss_rows=None):
    """(loss, d loss / d theta) of the port's dlm step; loss_rows restricts
    the outer loss to those batch elements."""
    gt, edges, meas, init = _arrays()
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(N, edges, meas, gt[0], dtype=torch.float64, device="cpu",
                                 edge_weight=w_odo, loop_weight=w_loop)
    theta = torch.tensor(THETA, dtype=torch.float64, requires_grad=True)
    kwargs = {"backward_mode": "dlm"}
    if mask is not None:
        kwargs["batch_ignore_mask"] = torch.as_tensor(mask)
    out, _ = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=GN_ITERS, linearization="sparse")).forward(
        dict(pose_values(torch.as_tensor(init)), w_loop=theta.reshape(1, 1)), optimizer_kwargs=kwargs)
    rows = slice(None) if loss_rows is None else torch.as_tensor(loss_rows)
    loss = mean_sq_local({k: v[rows] for k, v in out.items() if k.startswith("pose_")},
                         torch.as_tensor(gt)[:, rows])
    (g,) = torch.autograd.grad(loss, theta)
    return float(loss.detach()), float(g)


@pytest.mark.parametrize("whole", [False, True], ids=["levels", "whole"])
def test_dlm_outer_gradient_matches_jax(whole):
    config.set_whole_sweep(whole)
    try:
        loss, grad = _port_dlm()
    finally:
        config.set_whole_sweep(False)
    jloss, jgrad = _jax_dlm()
    assert grad != 0.0
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-9)


def test_dlm_frozen_elements_contribute_zero():
    """With elements 0 and 2 frozen, an outer loss on them alone has a zero
    gradient, and one on all elements the gradient of the loss on 1 and 3
    (scaled by the mean's 2/4)."""
    mask = [True, False, True, False]
    _, g_frozen = _port_dlm(mask, loss_rows=[0, 2])
    assert g_frozen == 0.0
    _, g_all = _port_dlm(mask)
    _, g_free = _port_dlm(mask, loss_rows=[1, 3])
    assert g_free != 0.0
    np.testing.assert_allclose(g_all, 0.5 * g_free, rtol=1e-12)


def test_dlm_initial_state_gets_zero_gradient():
    gt, edges, meas, init = _arrays()
    obj, _ = build_pgo_objective(N, edges, meas, gt[0], dtype=torch.float64, device="cpu")
    inputs = pose_values(torch.as_tensor(init))
    leaf = inputs["pose_3"] = inputs["pose_3"].clone().requires_grad_(True)
    out, _ = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=GN_ITERS, linearization="sparse")).forward(
        inputs, optimizer_kwargs={"backward_mode": "dlm"})
    (g,) = torch.autograd.grad(mean_sq_local(out, torch.as_tensor(gt)), leaf)
    assert torch.equal(g, torch.zeros_like(g))
