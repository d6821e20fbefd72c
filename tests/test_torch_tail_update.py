"""The dense tail's external update (`tail_update`, csrc/tail_update.cu) and its lists.

CPU: a numpy model of the kernel, which walks each output block's pair
list (`NumericSchedule.tail_out`, `tail_pair_ptr`, `tail_pairs`), against
the plain twin's symmetric dense matrix in float64, on the 6 x 6 grid and a
16-pose clique; and the lists' sizes on the benchmark's 50 x 50 snake grid.
CUDA (skipped without a card; this file imports no JAX): the kernel against
the twin at that grid's shape, batch 64, float32 and float64; two launches
equal bit for bit; one launch a factorization.

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
    """(schedule, LM-damped AtA, its factor) of a PGO problem drawn from a
    numpy seed."""
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
    return bld.sched, ata, factorize(bld.sched, ata)


def kernel_model(sched, ata, lflat):
    """numpy: what csrc/tail_update.cu computes, output block by output
    block from the schedule's lists, each pair list summed in order."""
    K, d = sched.tail_k, ata.shape[-1]
    a, l = ata.numpy(), lflat.numpy()
    dense = np.zeros((a.shape[1], K * d, K * d))
    for o, (j, r, a_slot, tr) in enumerate(sched.tail_out):
        acc = np.zeros((a.shape[1], d, d))
        for lr, lj in sched.tail_pairs[sched.tail_pair_ptr[o]:sched.tail_pair_ptr[o + 1]]:
            acc += l[lr] @ l[lj].transpose(0, 2, 1)
        c = (a[a_slot].transpose(0, 2, 1) if tr else a[a_slot]) - acc
        if j == r:
            dense[:, r * d:(r + 1) * d, j * d:(j + 1) * d] = 0.5 * (c + c.transpose(0, 2, 1))
        else:
            dense[:, r * d:(r + 1) * d, j * d:(j + 1) * d] = c
            dense[:, j * d:(j + 1) * d, r * d:(r + 1) * d] = c.transpose(0, 2, 1)
    return dense


@pytest.mark.parametrize("n,edges", [(36, grid_edges(6, 6)), (16, clique_edges(16))], ids=["grid6", "clique16"])
def test_lists_reproduce_the_twin(n, edges):
    """The kernel's lists, walked in numpy, give the plain twin's symmetric
    dense matrix to 1e-12 (float64)."""
    sched, ata, lflat = _system(n, edges, 3, torch.float64, "cpu")
    K = sched.tail_k
    assert K > 0 and len(sched.tail_out) == K * (K + 1) // 2
    assert sched.tail_pair_ptr[-1] == len(sched.tail_pairs)
    assert (len(sched.tail_pairs) > 0) == (sched.n_head > 0)
    want = tail_update_plain(sched.tail_on(ata.device), ata, lflat).numpy()
    np.testing.assert_allclose(kernel_model(sched, ata, lflat), want, rtol=0, atol=1e-12 * np.abs(want).max())
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
    123 columns, 7,626 output blocks and 124,956 pairs of nonzero blocks,
    of the 2,450,898 block products the padded tables name a batch element."""
    sched = _sphere2500_schedule()
    K = sched.tail_k
    assert (K, sched.tail_ue) == (123, 162)
    assert len(sched.tail_out) == 7626 == K * (K + 1) // 2
    assert len(sched.tail_pairs) == 124956 == sched.tail_pair_ptr[-1]
    assert sched.tail_upd_slots.size == 2450898
    # every pair is two nonzero slots, L[r, k] and L[j, k] of one head column
    assert (sched.tail_pairs > 0).all()
    assert sum(len(u) for u in sched.sym.tail_ext_upd) == len(np.unique(sched.tail_upd_jk[sched.tail_upd_valid])) == 9661


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
    """Batch 64 at the benchmark's shape; the twin (which gathers 22.6 GB
    in float32 at this batch) runs in slices of 8 batch elements. float64
    to 1e-12 of the largest entry, float32 to 2e-5: the twin sums each
    entry in a GEMM's order, the kernel pair by pair."""
    sched, ata, lflat = _sphere2500_system(dtype)
    _cuda.reset_launches()
    got = tail_update(sched, ata, lflat)
    again = tail_update(sched, ata, lflat)
    assert _cuda.launches["tail_update"] == 2
    with config.plain_path():
        want = torch.cat([tail_update(sched, ata[:, s:s + 8], lflat[:, s:s + 8]) for s in range(0, 64, 8)])
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
    lflat = [factorize(sched, ata) for _ in range(3)][-1]
    assert _cuda.launches["tail_update"] == 3
    want = factorize(sched, ata.cpu())
    torch.testing.assert_close(lflat.cpu(), want, rtol=1e-9, atol=1e-12)
