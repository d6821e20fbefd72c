"""utils/timer.py, utils/sparse_utils.py and utils/checkpoint.py of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The timer's stats and sync (a no-op on the CPU), the profiler and
fresh_eps; the batched CSR matvecs against scipy and the JAX package (the
same matrix from the same numpy RandomState, values and gradients to
1e-12), the split sizes equal to the JAX package's; checkpoints written by
either package and read by the other (values, nested structures, a module's
state_dict), and the JAX package's structure-mismatch error.
"""

import collections
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from theseus_tpu.utils import checkpoint as jck
from theseus_tpu.utils import sparse_utils as jsu
from theseus_tpu.utils import timer as jtimer
from theseus_tpu_torch.utils import Profiler, Timer, checkpoint as tck, device_sync, fresh_eps
from theseus_tpu_torch.utils import sparse_utils as tsu

TOL = dict(rtol=1e-12, atol=1e-12)


def test_timer_stats_and_cpu_sync():
    device_sync("cpu")  # a no-op without a card
    timer = Timer(sync=True)  # no card here: the sync is a no-op
    for _ in range(3):
        with timer("a"):
            time.sleep(0.002)
    timer.start("b")
    elapsed = timer.end()
    s = timer.summary()
    assert s["a"]["count"] == 3 and s["a"]["min"] >= 0.002 and s["a"]["max"] >= s["a"]["mean"] >= s["a"]["min"]
    assert s["b"]["count"] == 1 and s["b"]["mean"] == elapsed
    assert set(s["a"]) == set(jtimer.Timer(sync=False).summary().get("a", s["a"]))


def test_fresh_eps_and_profiler(tmp_path):
    eps = [fresh_eps(i) for i in range(4)]
    assert len(set(eps)) == 4 and all(1e-7 * (i + 1) <= e < 1e-7 * (i + 2) for i, e in enumerate(eps))
    prof = Profiler()
    prof.enable()
    sum(range(1000))
    prof.disable()
    prof.dump(str(tmp_path / "p.prof"))
    assert (tmp_path / "p.prof").stat().st_size > 0
    Profiler(enabled=False).dump(str(tmp_path / "none.prof"))
    assert not (tmp_path / "none.prof").exists()


def _csr(seed=0):
    a = tsu.random_sparse_binary_matrix(12, 9, 0.3, 2, np.random.RandomState(seed))
    want = jsu.random_sparse_binary_matrix(12, 9, 0.3, 2, np.random.RandomState(seed))
    assert (a != want).nnz == 0  # the JAX package's matrix for the same RandomState
    return a


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_matvecs_match_scipy_and_jax(seed):
    a = _csr(seed)
    rng = np.random.default_rng(seed)
    bsz = 3
    val, v, u = rng.standard_normal((bsz, a.nnz)), rng.standard_normal((bsz, 9)), rng.standard_normal((bsz, 12))
    av = tsu.mat_vec(9, a.indptr, a.indices, torch.as_tensor(val), torch.as_tensor(v))
    atu = tsu.tmat_vec(9, a.indptr, a.indices, torch.as_tensor(val), torch.as_tensor(u))
    for b in range(bsz):
        ab = sp.csr_matrix((val[b], a.indices, a.indptr), shape=(12, 9))
        np.testing.assert_allclose(av[b].numpy(), ab @ v[b], **TOL)
        np.testing.assert_allclose(atu[b].numpy(), ab.T @ u[b], **TOL)
    np.testing.assert_allclose(av.numpy(), np.asarray(jsu.mat_vec(9, a.indptr, a.indices, val, v)), **TOL)
    np.testing.assert_allclose(atu.numpy(), np.asarray(jsu.tmat_vec(9, a.indptr, a.indices, val, u)), **TOL)


def test_csr_matvec_gradients_match_jax():
    a = _csr()
    rng = np.random.default_rng(2)
    val, v = rng.standard_normal((2, a.nnz)), rng.standard_normal((2, 9))
    tv, tx = torch.as_tensor(val).requires_grad_(), torch.as_tensor(v).requires_grad_()
    loss = (tsu.sparse_mtv(9, a.indptr, a.indices, tv, tsu.sparse_mv(9, a.indptr, a.indices, tv, tx)) ** 2).sum()
    gv, gx = torch.autograd.grad(loss, (tv, tx))

    def jloss(val, v):
        return jnp.sum(jsu.tmat_vec(9, a.indptr, a.indices, val, jsu.mat_vec(9, a.indptr, a.indices, val, v)) ** 2)

    wv, wx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(val), jnp.asarray(v))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL)


def test_split_sizes_and_generator_draws():
    sizes = tsu.split_into_param_sizes(57, 2, 5, np.random.RandomState(3))
    np.testing.assert_array_equal(sizes, jsu.split_into_param_sizes(57, 2, 5, np.random.RandomState(3)))
    np.testing.assert_array_equal(tsu.split_into_param_sizes(57, 2, 5), jsu.split_into_param_sizes(57, 2, 5))
    g = tsu.split_into_param_sizes(57, 2, 5, generator=torch.Generator().manual_seed(0))
    assert g.sum() == 57 and g.min() >= 1 and g.max() <= 5
    a = tsu.random_sparse_binary_matrix(10, 7, 0.2, 3, generator=torch.Generator().manual_seed(0))
    assert a.shape == (10, 7) and (np.diff(a.tocsc().indptr) >= 3).all()
    b = tsu.random_sparse_binary_matrix(10, 7, 0.2, 3, generator=torch.Generator().manual_seed(0))
    assert (a != b).nnz == 0


def test_values_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    vals = {"a": torch.as_tensor(rng.standard_normal((2, 3))), "b": torch.tensor([1.5, -2.5], dtype=torch.float32)}
    tck.save_values(str(tmp_path / "t"), vals)
    back = tck.load_values(str(tmp_path / "t"), device="cpu")
    jback = jck.load_values(str(tmp_path / "t.npz"))
    for k, v in vals.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)
        np.testing.assert_array_equal(np.asarray(jback[k]), v.numpy())
    assert tck.load_values(str(tmp_path / "t.npz"), dtype=torch.float64, device="cpu")["b"].dtype == torch.float64
    jck.save_values(str(tmp_path / "j"), {"x": jnp.arange(6.0).reshape(2, 3)})
    np.testing.assert_array_equal(tck.load_values(str(tmp_path / "j"), device="cpu")["x"].numpy(), np.arange(6.0).reshape(2, 3))


Point = collections.namedtuple("Point", ["x", "y"])


def _tree(pkg):
    arr = torch.as_tensor if pkg == "torch" else jnp.asarray
    return {
        "state": [arr(np.ones((2, 2))), arr(np.zeros(3))],
        "info": Point(x=arr(np.array([1.0])), y=arr(np.array([2.0, 3.0]))),
        "step": arr(np.array(7)),
        "b_then_a": {"b": arr(np.array([4.0])), "a": (arr(np.array([5.0])), None)},
    }


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_pytree_round_trip_across_packages(tmp_path, writer):
    (tck if writer == "torch" else jck).save_pytree(str(tmp_path / "tree"), _tree(writer))
    back = tck.load_pytree(str(tmp_path / "tree"), like=_tree("torch"), device="cpu")
    assert isinstance(back["info"], Point) and back["b_then_a"]["a"][1] is None
    for a, b in zip(jax.tree_util.tree_leaves(_tree("jax")), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), back, is_leaf=lambda t: isinstance(t, torch.Tensor)))):
        np.testing.assert_array_equal(np.asarray(a), b)
    jback = jck.load_pytree(str(tmp_path / "tree"), like=_tree("jax"))
    for a, b in zip(jax.tree_util.tree_leaves(_tree("jax")), jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_dict_round_trip(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3), torch.nn.ReLU(), torch.nn.Conv2d(4, 2, 3))
    tck.save_pytree(tmp_path / "net", net.state_dict())
    other = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3), torch.nn.ReLU(), torch.nn.Conv2d(4, 2, 3))
    other.load_state_dict(tck.load_pytree(tmp_path / "net", like=other.state_dict(), device="cpu"))
    for (k, a), (_, b) in zip(net.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), k


def test_pytree_structure_mismatch_raises(tmp_path):
    tck.save_pytree(str(tmp_path / "t"), {"a": torch.ones(2)})
    with pytest.raises(ValueError):
        tck.load_pytree(str(tmp_path / "t"), like={"a": torch.ones(2), "b": torch.ones(2)}, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the default device is the card
        tck.load_values(str(tmp_path / "t"))
    with pytest.raises(ValueError):  # the JAX package raises the same error on the same file
        jck.load_pytree(str(tmp_path / "t"), like={"a": jnp.ones(2), "b": jnp.ones(2)})
