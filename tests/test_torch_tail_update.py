"""The dense tail's external update (`tail_update`, csrc/tail_update.cu) and its lists.

CPU: a numpy model of the kernel, which walks each output block's pair
list (`NumericSchedule.tail_out`, `tail_pair_ptr`, `tail_pairs`), and the
JAX package's `_tail_assemble_C` (symmetrised here) against the plain
twin's symmetric dense matrix in float64, on the 6 x 6 and 8 x 8 grids and
a 16-pose clique; the lists' sizes on the benchmark's 50 x 50 snake grid,
and the twin against the numpy model there at batch 1.
CUDA (skipped without a card; this file imports JAX only inside a CPU
test): the kernel against the twin at that grid's shape, batch 64, float32
and float64; two launches equal bit for bit; one launch a factorization.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tail_update.py
"""

import functools

import numpy as np
import pytest
import torch

from theseus_tpu_torch import _cuda, config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
from theseus_tpu_torch.sparse.cholesky import factorize
from theseus_tpu_torch.sparse.level_kernels import tail_update, tail_update_plain
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values


def grid_edges(rows, cols):
    """A rows x cols grid numbered along the chain that snakes through it:
    the chain's edges, then every other grid edge (portbench's layout)."""
    at = lambda i, j: i * cols + (j if i % 2 == 0 else cols - 1 - j)  # noqa: E731
    vertical = [(min(at(i, j), at(i + 1, j)), max(at(i, j), at(i + 1, j)))
                for i in range(rows - 1) for j in range(cols)]
    return [(k, k + 1) for k in range(rows * cols - 1)] + [e for e in vertical if e[1] - e[0] > 1]


def clique_edges(n):
    return [(i, i + 1) for i in range(n - 1)] + [(i, j) for i in range(n) for j in range(i + 2, n)]


def _system(n, edges, batch, dtype, device, seed=0):
    """(schedule, LM-damped AtA, its factor's blocks) of a PGO problem drawn
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    normal = lambda *s: torch.as_tensor(rng.standard_normal(s))  # noqa: E731
    gt = se3.exp(0.5 * normal(n, batch, 6))
    e = torch.as_tensor(edges)
    meas = se3.compose(se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]]), se3.exp(0.05 * normal(len(edges), batch, 6)))
    init = se3.compose(gt, se3.exp(0.2 * normal(n, batch, 6)))
    cast = lambda t: t.to(dtype=dtype, device=device)  # noqa: E731
    obj, _ = build_pgo_objective(n, edges, cast(meas), cast(gt[0]), dtype=dtype, device=device)
    co = obj.compile()
    values = obj.default_values(pose_values(cast(init)))
    state, aux = co.pack(values, batch), co.build_aux(values, batch)
    bld = SparseNormalBuilder(co)
    with config.plain_path():
        ata, _ = assemble(bld.pattern, co.linearize_blocks(state, aux))
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    return bld.sched, ata, factorize(bld.sched, ata).blocks


def kernel_model(sched, ata, lflat):
    """numpy: what csrc/tail_update.cu computes, output block by output
    block from the schedule's lists, each pair list summed in order."""
    K, d = sched.tail_k, ata.shape[-1]
    a, l = ata.numpy(), lflat.numpy()
    products = np.einsum("pbik,pbjk->pbij", l[sched.tail_pairs[:, 0]], l[sched.tail_pairs[:, 1]])
    dense = np.zeros((a.shape[1], K * d, K * d))
    for o, (j, r, a_slot, tr) in enumerate(sched.tail_out):
        acc = np.zeros((a.shape[1], d, d))
        for p in range(sched.tail_pair_ptr[o], sched.tail_pair_ptr[o + 1]):
            acc += products[p]
        c = (a[a_slot].transpose(0, 2, 1) if tr else a[a_slot]) - acc
        if j == r:
            dense[:, r * d:(r + 1) * d, j * d:(j + 1) * d] = 0.5 * (c + c.transpose(0, 2, 1))
        else:
            dense[:, r * d:(r + 1) * d, j * d:(j + 1) * d] = c
            dense[:, j * d:(j + 1) * d, r * d:(r + 1) * d] = c.transpose(0, 2, 1)
    return dense


def jax_tail_matrix(n, edges, ata, lflat):
    """The JAX package's `_tail_assemble_C` on the same AtA and blocks (its
    schedule numbers the slots as the port's does), symmetrised as its
    `_tail_dense_eliminate` does: the strict lower blocks, their transposes,
    the diagonal blocks as 0.5 (C + C^T). numpy (B, K d, K d)."""
    import jax.numpy as jnp

    from theseus_tpu.optim.normal import SparseNormalBuilder as JBuilder
    from theseus_tpu.sparse.cholesky import _tail_assemble_C
    from theseus_tpu.utils.examples.pose_graph import build_pgo_objective as jbuild

    eye = np.eye(3, 4)
    jobj, _ = jbuild(n, edges, np.tile(eye, (len(edges), 1, 1, 1)), eye[None], dtype=jnp.float64)
    js = JBuilder(jobj.compile()).sched
    c = np.asarray(_tail_assemble_C(js, jnp.asarray(ata.numpy()), jnp.asarray(lflat.numpy())))
    K, bsz, d = js.tail_k, c.shape[2], c.shape[-1]
    dense = np.zeros((bsz, K * d, K * d))
    for j in range(K):
        for r in range(j, K):
            blk = 0.5 * (c[j, r] + c[j, r].transpose(0, 2, 1)) if r == j else c[j, r]
            dense[:, r * d:(r + 1) * d, j * d:(j + 1) * d] = blk
            dense[:, j * d:(j + 1) * d, r * d:(r + 1) * d] = blk.transpose(0, 2, 1)
    return dense


@pytest.mark.parametrize("n,edges", [(36, grid_edges(6, 6)), (64, grid_edges(8, 8)), (16, clique_edges(16))],
                         ids=["grid6", "grid8", "clique16"])
def test_lists_reproduce_the_twin(n, edges):
    """The kernel's lists, walked in numpy, and the JAX package's padded
    update give the plain twin's symmetric dense matrix to 1e-12 of its
    largest entry (float64)."""
    sched, ata, lflat = _system(n, edges, 3, torch.float64, "cpu")
    K = sched.tail_k
    assert K > 0 and len(sched.tail_out) == K * (K + 1) // 2
    assert sched.tail_pair_ptr[-1] == len(sched.tail_pairs)
    assert (len(sched.tail_pairs) > 0) == (sched.n_head > 0)
    want = tail_update_plain(sched.tail_on(ata.device), ata, lflat).numpy()
    tol = 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(kernel_model(sched, ata, lflat), want, rtol=0, atol=tol)
    np.testing.assert_allclose(jax_tail_matrix(n, edges, ata, lflat), want, rtol=0, atol=tol)
    # the entry point takes the twin on a CPU tensor
    assert torch.equal(tail_update(sched, ata, lflat), torch.as_tensor(want))


@functools.lru_cache(maxsize=None)
def _sphere2500_schedule():
    n, edges = 2500, grid_edges(50, 50)
    gt = se3.exp(torch.zeros(n, 1, 6, dtype=torch.float64))
    e = torch.as_tensor(edges)
    meas = se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=torch.float64, device="cpu")
    return SparseNormalBuilder(obj.compile()).sched


def test_sphere2500_lists():
    """The benchmark's 50 x 50 snake grid under the auto ordering: a tail of
    123 columns, 7,626 output blocks and 124,956 pairs of nonzero blocks.
    The twin walks them at batch 1 on the CPU and gives the numpy model's
    matrix (random AtA and blocks: the arithmetic does not need a factor)."""
    sched = _sphere2500_schedule()
    K = sched.tail_k
    assert (K, sched.tail_ue) == (123, 162)
    assert len(sched.tail_out) == 7626 == K * (K + 1) // 2
    assert len(sched.tail_pairs) == 124956 == sched.tail_pair_ptr[-1]
    # every pair is two nonzero slots, L[r, k] and L[j, k] of one head column
    assert (sched.tail_pairs > 0).all()
    assert sum(len(u) for u in sched.sym.tail_ext_upd) == len(np.unique(sched.tail_upd_jk[sched.tail_upd_valid])) == 9661
    gen = torch.Generator().manual_seed(0)
    ata = torch.randn((sched.pattern.n_slots, 1, 6, 6), generator=gen, dtype=torch.float64)
    lflat = torch.randn((sched.sym.nnz_l + 1, 1, 6, 6), generator=gen, dtype=torch.float64)
    lflat[0] = 0.0
    got = tail_update_plain(sched.tail_on(ata.device), ata, lflat).numpy()
    want = kernel_model(sched, ata, lflat)
    assert got.shape == (1, 738, 738)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _sphere2500_system(dtype):
    return _system(2500, grid_edges(50, 50), 64, dtype, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_at_sphere2500(cuda_device, dtype):
    """Batch 64 at the benchmark's shape. float64 to 1e-12 of the largest
    entry, float32 to 2e-5: the twin sums each output's pair products with
    the card's atomic `index_add_`, the kernel pair by pair in list order."""
    sched, ata, lflat = _sphere2500_system(dtype)
    _cuda.reset_launches()
    got = tail_update(sched, ata, lflat)
    again = tail_update(sched, ata, lflat)
    assert _cuda.launches["tail_update"] == 2
    with config.plain_path():
        want = tail_update(sched, ata, lflat)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.shape == (64, 738, 738) and bool(torch.isfinite(got).all())
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


@pytest.mark.cuda
def test_one_launch_a_factorization(cuda_device):
    """A ragged batch (a multiple of no warp) on the 6 x 6 grid: each
    factorization launches the kernel once, and the factor matches the
    CPU twins'."""
    sched, ata, _ = _system(36, grid_edges(6, 6), 37, torch.float64, cuda_device)
    _cuda.reset_launches()
    got = [factorize(sched, ata) for _ in range(3)][-1]
    assert _cuda.launches["tail_update"] == 3
    want = factorize(sched, ata.cpu())
    torch.testing.assert_close(got.blocks.cpu(), want.blocks, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(got.tail.cpu(), want.tail, rtol=1e-9, atol=1e-12)
