"""The Between linearization of theseus_tpu_torch against the JAX package, on the CPU.

`between_linearize` on a CPU tensor runs its plain twin (the CUDA kernel is
checked against the same twin on the card, tests/test_torch_cuda.py). Here
the twin is held against the JAX package's `_reference_linearize`, the
pure-JAX formulation its Pallas kernel was validated against, in float64:
tolerance 1e-11 absolute on O(1..10) jacobian entries (same formulas,
different rounding order), and 1e-7 at the near-pi edge, where both
packages recover the rotation axis from a rank-one matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.lie import se3 as jse3
from theseus_tpu.ops.pallas_between_soa import _reference_linearize
from theseus_tpu_torch import _cuda
from theseus_tpu_torch.embodied import Between
from theseus_tpu_torch.core import SE3
from theseus_tpu_torch.ops.between_se3 import between_linearize, between_linearize_plain


def _poses(rng, shape, scale):
    return np.array(jse3.exp(jnp.asarray(scale * rng.standard_normal(shape + (6,)))))


def _problem(case, K=11, B=4, seed=0):
    rng = np.random.default_rng(seed)
    v1 = _poses(rng, (K, B), 1.0)
    v2 = _poses(rng, (K, B), 1.0)
    d = np.asarray(jse3.compose(jse3.inverse(v1), v2))
    if case == "generic":
        meas = _poses(rng, (K, B), 1.0)
    elif case == "near_zero":  # m^-1 d within the near-zero eps
        meas = np.array(jse3.compose(d, _poses(rng, (K, B), 1e-4)))
    else:  # m^-1 d a rotation by pi - 1e-5 about a random axis
        axis = rng.standard_normal((K, B, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        w = np.concatenate([rng.standard_normal((K, B, 3)), (np.pi - 1e-5) * axis], axis=-1)
        meas = np.array(jse3.compose(d, jse3.inverse(jse3.exp(jnp.asarray(w)))))
    return v1, v2, meas


@pytest.mark.parametrize("case", ["generic", "near_zero", "near_pi"])
def test_plain_twin_matches_jax_reference(case):
    v1, v2, meas = _problem(case)
    want = _reference_linearize(jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(meas))
    got = between_linearize(*(torch.as_tensor(a) for a in (v1, v2, meas)))
    atol = 1e-7 if case == "near_pi" else 1e-11
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def test_cpu_tensor_runs_twin_and_launches_nothing():
    v1, v2, meas = (torch.as_tensor(a) for a in _problem("generic", K=3, B=2))
    _cuda.reset_launches()
    got = between_linearize(v1, v2, meas)
    want = between_linearize_plain(v1, v2, meas)
    assert _cuda.launches["between_se3"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_shared_measurement_broadcasts():
    v1, v2, meas = (torch.as_tensor(a) for a in _problem("generic", K=5, B=3))
    got = between_linearize(v1, v2, meas[0])  # (B, 3, 4): one measurement for all edges
    want = between_linearize_plain(v1, v2, meas[0].expand(v1.shape))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_fused_path_matches_cost_jacobians():
    """The bucket-level fused linearization and the cost's analytic
    jacobians are the same function (1e-12, float64)."""
    v1, v2, meas = (torch.as_tensor(a) for a in _problem("generic", K=6, B=2, seed=5))
    cost = Between(SE3(name="a"), SE3(name="b"), meas[0])
    (j1, j2), err = cost.fused_linearize((v1, v2), (meas,))
    (k1, k2), err2 = cost.jacobians_impl((v1, v2), (meas,))
    for a, b in ((j1, k1), (j2, k2), (err, err2)):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)
    torch.testing.assert_close(cost.fused_error((v1, v2), (meas,)), cost.error_impl((v1, v2), (meas,)),
                               atol=1e-12, rtol=0)


def test_requires_grad_is_refused():
    """Inputs that require grad are no longer refused: the linearization goes
    through its autograd Function, whose gradient is the twin's (1e-12)."""
    v1, v2, meas = (torch.as_tensor(a) for a in _problem("generic", K=2, B=2))
    v1.requires_grad_(True)
    outs = between_linearize(v1, v2, meas)
    assert all(o.grad_fn is not None for o in outs)
    (got,) = torch.autograd.grad(sum(o.sum() for o in outs), v1)
    p = v1.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(sum(o.sum() for o in between_linearize_plain(p, v2, meas)), p)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


def test_float32_twin_close_to_float64():
    """float32 twin vs float64: the working precision of the bench path
    (2e-5 absolute: a few hundred ulp on entries of order 1..10)."""
    v1, v2, meas = _problem("generic", seed=7)
    f64 = between_linearize(*(torch.as_tensor(a) for a in (v1, v2, meas)))
    f32 = between_linearize(*(torch.as_tensor(a, dtype=torch.float32) for a in (v1, v2, meas)))
    for a, b in zip(f32, f64):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), atol=2e-5, rtol=0)
