"""Small public functions of the JAX package's Lie and linear-algebra layers, in theseus_tpu_torch, against the JAX package on the CPU in float64.

`se2`/`se3` `rotation` and `translation`, `rn.retract` and `rn.local`,
`so3.jquaternion_to_rotation` (the jacobian and the rotation),
`lie.utils.mmp`, the method `LieArray.jinv`, `ops.batched_linalg.solve_lower_mat`,
and the names `theseus_tpu_torch.utils` exports from its `checks` module.
Every value and jacobian agrees to 1e-12; numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu.lie as jlie
from theseus_tpu.lie import lie_array as jla
from theseus_tpu.ops import batched_linalg as jlin
import theseus_tpu_torch.lie as tlie
from theseus_tpu_torch.lie import lie_array as tla
from theseus_tpu_torch.ops import batched_linalg as tlin

TOL = dict(rtol=1e-12, atol=1e-12)
RNG = np.random.default_rng(0)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), **TOL)


def _elements(group, b=5):
    t = 0.8 * RNG.standard_normal((b, jlie.by_name(group).dof))
    return np.array(jlie.by_name(group).exp(jnp.asarray(t)))


@pytest.mark.parametrize("group", ["SE2", "SE3"])
@pytest.mark.parametrize("fn", ["rotation", "translation"])
def test_rotation_translation_match_jax(group, fn):
    g = _elements(group)
    mod_t, mod_j = getattr(tlie, group.lower()), getattr(jlie, group.lower())
    _close(getattr(mod_t, fn)(torch.as_tensor(g)), getattr(mod_j, fn)(jnp.asarray(g)))


@pytest.mark.parametrize("fn", ["retract", "local"])
def test_rn_retract_local_match_jax(fn):
    a, b = RNG.standard_normal((2, 4, 3))
    _close(getattr(tlie.rn, fn)(torch.as_tensor(a), torch.as_tensor(b)),
           getattr(jlie.rn, fn)(jnp.asarray(a), jnp.asarray(b)))


def test_jquaternion_to_rotation_matches_jax():
    q = RNG.standard_normal((6, 4)) * np.array([[2.0, 1.0, 0.5, 1.5]])  # unnormalized
    (jac,), rot = tlie.so3.jquaternion_to_rotation(torch.as_tensor(q))
    (wjac,), wrot = jlie.so3.jquaternion_to_rotation(jnp.asarray(q))
    assert jac.shape == (6, 3, 4)
    _close(jac, wjac)
    _close(rot, wrot)
    _close(rot, tlie.so3.quaternion_to_rotation(torch.as_tensor(q)))


def test_mmp_matches_jax():
    a, b = RNG.standard_normal((3, 1, 4, 5)), RNG.standard_normal((2, 5, 3))
    _close(tlie.utils.mmp(torch.as_tensor(a), torch.as_tensor(b)), jlie.utils.mmp(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("group", ["SO2", "SE2", "SO3", "SE3"])
def test_lie_array_jinv_matches_jax(group):
    g = _elements(group)
    (jac,), inv = tla.LieArray(torch.as_tensor(g), tlie.by_name(group)).jinv()
    (wjac,), winv = jla.LieArray(jnp.asarray(g), jlie.by_name(group)).jinv()
    _close(jac, wjac)
    _close(inv.data, winv.data)
    assert inv.group is tlie.by_name(group)


@pytest.mark.parametrize("k", [1, 4])
def test_solve_lower_mat_matches_jax(k):
    m = RNG.standard_normal((3, 6, 6))
    l = np.linalg.cholesky(m @ np.swapaxes(m, -1, -2) + 6 * np.eye(6))
    b = RNG.standard_normal((3, 6, k))
    got = tlin.solve_lower_mat(torch.as_tensor(l), torch.as_tensor(b))
    _close(got, jlin.solve_lower_mat(jnp.asarray(l), jnp.asarray(b)))
    _close(torch.as_tensor(l) @ got, b)


def test_utils_exports_checks_names():
    import theseus_tpu.utils as jutils
    import theseus_tpu_torch.utils as tutils
    from theseus_tpu_torch.utils import checks

    for name in ("check_jacobians", "numeric_jacobian", "autodiff_jacobian", "build_mlp",
                 "gather_from_rows_cols"):
        assert hasattr(jutils, name)
        assert getattr(tutils, name) is getattr(checks, name)
