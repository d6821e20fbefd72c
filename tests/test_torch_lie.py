"""theseus_tpu_torch.lie against theseus_tpu.lie, in float64 on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerance: 1e-12 absolute on O(1) values (the same formulas in two
frameworks; only rounding order differs), including inputs near theta = 0
(the Taylor branches) and near theta = pi (the SO3 log's antipodal branch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.lie import se3 as jse3
from theseus_tpu.lie import so3 as jso3
from theseus_tpu.lie.group import SE3 as JSE3
from theseus_tpu_torch.lie import se3, so3
from theseus_tpu_torch.lie.group import SE3

ATOL = 1e-12
# rotation-angle regimes: generic, inside the near-zero eps (f64: 5e-3), inside
# the derivative branch eps (1e-2) only, near pi (1 + cos <= 1e-7), and at pi
ANGLES = {"generic": 1.3, "near_zero": 1e-3, "d_near_zero": 7e-3, "near_pi": np.pi - 1e-5, "pi": np.pi}


def _tangents(rng, n, angle):
    """(n, 6) tangents [lin; ang] with |ang| = angle along random axes."""
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return np.concatenate([rng.standard_normal((n, 3)), angle * axis], axis=-1)


def _both(x):
    return jnp.asarray(x), torch.as_tensor(np.array(x))


def _check(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("regime", list(ANGLES))
def test_se3_exp(regime):
    x = _tangents(np.random.default_rng(0), 16, ANGLES[regime])
    jx, tx = _both(x)
    _check(jse3.exp(jx), se3.exp(tx))


@pytest.mark.parametrize("regime", list(ANGLES))
def test_se3_log_and_jlog(regime):
    g = np.asarray(jse3.exp(jnp.asarray(_tangents(np.random.default_rng(1), 16, ANGLES[regime]))))
    jg, tg = _both(g)
    (jj,), jw = jse3.jlog(jg)
    (tj,), tw = se3.jlog(tg)
    # near pi the log's axis is recovered from a rank-one matrix, which loses
    # about half the digits in both packages
    tol = 1e-7 if regime in ("near_pi", "pi") else ATOL
    _check(jw, tw, tol)
    _check(jj, tj, tol)
    _check(jse3.log(jg), se3.log(tg), tol)


@pytest.mark.parametrize("regime", list(ANGLES))
def test_so3_exp_log_jlog(regime):
    w = _tangents(np.random.default_rng(2), 16, ANGLES[regime])[:, 3:]
    jw, tw = _both(w)
    _check(jso3.exp(jw), so3.exp(tw))
    r = np.asarray(jso3.exp(jw))
    jr, tr = _both(r)
    (jj,), jl = jso3.jlog(jr)
    (tj,), tl = so3.jlog(tr)
    tol = 1e-7 if regime in ("near_pi", "pi") else ATOL
    _check(jl, tl, tol)
    _check(jj, tj, tol)


@pytest.mark.parametrize("op", ["compose", "between", "local", "retract", "inverse", "adjoint"])
def test_se3_group_ops(op):
    rng = np.random.default_rng(3)
    a = np.asarray(jse3.exp(jnp.asarray(_tangents(rng, 8, 1.0))))
    b = np.asarray(jse3.exp(jnp.asarray(_tangents(rng, 8, 2.0))))
    delta = _tangents(rng, 8, 0.5)
    (ja, ta), (jb, tb), (jd, td) = _both(a), _both(b), _both(delta)
    if op == "compose":
        want, got = jse3.compose(ja, jb), se3.compose(ta, tb)
    elif op == "between":
        want, got = JSE3.between(ja, jb), SE3.between(ta, tb)
    elif op == "local":
        want, got = JSE3.local(ja, jb), SE3.local(ta, tb)
    elif op == "retract":
        want, got = JSE3.retract(ja, jd), SE3.retract(ta, td)
    elif op == "inverse":
        want, got = jse3.inverse(ja), se3.inverse(ta)
    else:
        want, got = jse3.adjoint(ja), se3.adjoint(ta)
    _check(want, got)


def test_broadcast_over_leading_dims():
    """(K, B) stacks against a shared (B,) operand, as the compiled
    objective evaluates buckets."""
    rng = np.random.default_rng(4)
    a = se3.exp(torch.as_tensor(_tangents(rng, 15, 1.0))).reshape(5, 3, 3, 4)
    b = se3.exp(torch.as_tensor(_tangents(rng, 3, 1.0)))
    got = SE3.local(b, a)
    want = torch.stack([SE3.local(b, a[k]) for k in range(5)])
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("op", ["so3_left_project", "se3_left_project", "quaternion_to_rotation"])
def test_projections_and_quaternions(op):
    """The DLM backward's map of an ambient cotangent to the right tangent
    (`Group.egrad_to_tangent`, falling back to `left_project`), and the g2o
    reader's quaternion conversion (unnormalized input)."""
    import jax

    rng = np.random.default_rng(7)
    if op == "quaternion_to_rotation":
        jq, tq = _both(rng.standard_normal((6, 4)))
        _check(jso3.quaternion_to_rotation(jq), so3.quaternion_to_rotation(tq))
        return
    g = np.asarray(jax.vmap(jse3.exp)(jnp.asarray(_tangents(rng, 6, 1.3))))
    jg, tg = _both(g if op == "se3_left_project" else g[..., :3])
    jm, tm = _both(rng.standard_normal(jg.shape))
    jmod, tmod = (jse3, se3) if op == "se3_left_project" else (jso3, so3)
    _check(jax.vmap(jmod.left_project)(jg, jm), tmod.left_project(tg, tm))
    if op == "se3_left_project":
        _check(jax.vmap(JSE3.egrad_to_tangent)(jg, jm), SE3.egrad_to_tangent(tg, tm))
