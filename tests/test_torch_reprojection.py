"""The Reprojection linearization of theseus_tpu_torch against the JAX package, on the CPU.

`reprojection_linearize` on a CPU tensor runs its plain twin (the CUDA
kernel is checked against the same twin on the card, tests/test_torch_cuda.py).
Here the twin is held, in float64, against

- the JAX package's `_reference_linearize`, the pure-JAX closed form its
  Pallas kernel was validated against: the same formulas, so 1e-12 relative
  to the output's scale (errors and jacobians carry the focal length,
  about 1e3);
- the JAX `Reprojection` cost's own jacobians, which on the CPU come from
  jacfwd through the retract: another derivation of the same function,
  1e-10 relative to scale.

Inputs are numpy draws from a seed, with nonzero radial distortion, points
in front of every camera, and shared (B, 1) aux next to stacked (K, B, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu import core as jcore
from theseus_tpu.embodied import Reprojection as JReprojection
from theseus_tpu.lie import se3 as jse3
from theseus_tpu.ops.pallas_reprojection import _reference_linearize
from theseus_tpu_torch import _cuda
from theseus_tpu_torch.core import SE3, Point3
from theseus_tpu_torch.embodied import Reprojection
from theseus_tpu_torch.ops.reprojection import reprojection_linearize, reprojection_linearize_plain


def _inputs(K=13, B=3, seed=0, shared=False):
    """pose, point, focal, feat, k1, k2 as float64 numpy; with shared=True,
    focal, k1 and k2 are one (B, 1) value for every observation."""
    rng = np.random.default_rng(seed)
    pose = np.array(jse3.exp(jnp.asarray(0.2 * rng.standard_normal((K, B, 6)))))
    # points about 5 units ahead of the camera, whatever its pose
    p_cam = rng.uniform(-1.0, 1.0, (K, B, 3)) + np.array([0.0, 0.0, -5.0])
    r, t = pose[..., :3], pose[..., 3]
    point = np.einsum("kbji,kbj->kbi", r, p_cam - t)
    kshape = (B, 1) if shared else (K, B, 1)
    focal = 1000.0 + 50.0 * rng.standard_normal(kshape)
    k1 = 0.1 * rng.standard_normal(kshape)
    k2 = 0.01 * rng.standard_normal(kshape)
    feat = 200.0 * rng.standard_normal((K, B, 2))
    return pose, point, focal, feat, k1, k2


def _rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("shared", [False, True])
def test_plain_twin_matches_jax_reference(shared):
    args = _inputs(shared=shared)
    K = args[0].shape[0]
    jargs = [a if a.ndim == 4 or a.shape[0] == K else np.broadcast_to(a, (K,) + a.shape) for a in args]
    want = _reference_linearize(*(jnp.asarray(a) for a in jargs))
    got = reprojection_linearize(*(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w, 1e-12)


@pytest.mark.parametrize("shared", [False, True])
def test_closed_form_matches_jax_cost_jacfwd(shared):
    """The port's closed form against the JAX cost's jacfwd-through-retract
    jacobians (its non-fused path), instance by instance."""
    pose, point, focal, feat, k1, k2 = _inputs(K=7, B=2, seed=3, shared=shared)
    K = pose.shape[0]
    jcost = JReprojection(jcore.SE3(name="c"), jcore.Point3(name="p"), np.zeros((1, 1)), np.zeros((1, 2)))
    jfn = jcost.jacobians_fn()
    full = [a if a.shape[0] == K and a.ndim == 3 else np.broadcast_to(a, (K,) + a.shape)
            for a in (focal, feat, k1, k2)]
    jjac, jerr = jax.vmap(jax.vmap(lambda x, p, f, o, a, b: jfn((x, p), (f, o, a, b))))(
        *(jnp.asarray(a) for a in (pose, point, *full)))

    cost = Reprojection(SE3(name="c"), Point3(name="p"), np.zeros((1, 1)), np.zeros((1, 2)))
    (jpose, jpt), err = cost.jacobians_impl(
        (torch.as_tensor(pose), torch.as_tensor(point)),
        tuple(torch.as_tensor(a) for a in (focal, feat, k1, k2)))
    _rel_close(jpose.numpy(), jjac[0], 1e-10)
    _rel_close(jpt.numpy(), jjac[1], 1e-10)
    _rel_close(err.numpy(), jerr, 1e-12)
    # and the error-only path equals the JAX cost's error_impl
    e = cost.error_impl((torch.as_tensor(pose), torch.as_tensor(point)),
                        tuple(torch.as_tensor(a) for a in (focal, feat, k1, k2)))
    _rel_close(e.numpy(), jerr, 1e-12)


def test_fused_path_matches_cost_jacobians():
    args = [torch.as_tensor(a) for a in _inputs(K=6, B=2, seed=5, shared=True)]
    cost = Reprojection(SE3(name="c"), Point3(name="p"), np.zeros((1, 1)), np.zeros((1, 2)))
    (j1, j2), err = cost.fused_linearize(args[:2], args[2:])
    (k1, k2), err2 = cost.jacobians_impl(args[:2], args[2:])
    for a, b in ((j1, k1), (j2, k2), (err, err2)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(cost.fused_error(args[:2], args[2:]), cost.error_impl(args[:2], args[2:]),
                               atol=1e-9, rtol=1e-12)


def test_cpu_tensor_runs_twin_and_launches_nothing():
    args = [torch.as_tensor(a) for a in _inputs(K=4, B=2)]
    _cuda.reset_launches()
    got = reprojection_linearize(*args)
    want = reprojection_linearize_plain(*args)
    assert _cuda.launches["reprojection"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_shared_aux_is_a_zero_stride_view():
    pose, point, focal, feat, k1, k2 = (torch.as_tensor(a) for a in _inputs(K=5, B=3, shared=True))
    from theseus_tpu_torch.ops.reprojection import broadcast_aux

    f, x, a, b = broadcast_aux(pose, (focal, feat, k1, k2))
    assert f.shape == (5, 3, 1) and f.stride(0) == 0 and x is feat
    got = reprojection_linearize(pose, point, focal, feat, k1, k2)
    want = reprojection_linearize_plain(pose, point, f.contiguous(), feat, a.contiguous(), b.contiguous())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_point_on_the_camera_plane_is_not_finite():
    """No clamp of P_z, as in the JAX package: a point with P_z = 0 gives a
    non-finite error and jacobian in both."""
    pose, point, focal, feat, k1, k2 = _inputs(K=3, B=1, seed=2)
    pose[0, 0] = np.eye(3, 4)  # camera at the origin: P = p exactly
    point[0, 0] = [0.3, -0.2, 0.0]
    got = reprojection_linearize(*(torch.as_tensor(a) for a in (pose, point, focal, feat, k1, k2)))
    want = _reference_linearize(*(jnp.asarray(a) for a in (pose, point, focal, feat, k1, k2)))
    for g, w in zip(got, want):
        assert not torch.isfinite(g[0, 0]).all() and not np.isfinite(np.asarray(w)[0, 0]).all()
        assert torch.isfinite(g[1:]).all()


def test_requires_grad_is_refused():
    """Inputs that require grad are no longer refused: the call goes through
    the autograd Function and the points get a finite, non-zero gradient
    (tests/test_torch_ba_backward.py holds it against the JAX package)."""
    args = [torch.as_tensor(a) for a in _inputs(K=2, B=2)]
    args[1].requires_grad_(True)
    jpose, jpt, err = reprojection_linearize(*args)
    (grad,) = torch.autograd.grad(jpose.sum() + jpt.sum() + err.sum(), args[1])
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def test_float32_twin_close_to_float64():
    """The float32 twin against float64: a few hundred ulp of the output's
    scale (entries up to ~1e4)."""
    args = _inputs(seed=7)
    f64 = reprojection_linearize(*(torch.as_tensor(a) for a in args))
    f32 = reprojection_linearize(*(torch.as_tensor(a, dtype=torch.float32) for a in args))
    for a, b in zip(f32, f64):
        _rel_close(a.double().numpy(), b.numpy(), 2e-5)
