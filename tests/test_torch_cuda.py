"""CUDA kernels of theseus_tpu_torch against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc; without a card each skips
(decided inside the `cuda_device` fixture, never at import). This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float64 kernels agree with their twins to ~1e-12 (same
formulas, different summation order and FMA contraction); float32 to a few
ulp of the operands' magnitude, stated per test.
"""

import numpy as np
import pytest
import torch

from theseus_tpu_torch import _cuda, config
from theseus_tpu_torch.lie import se3
from theseus_tpu_torch.ops.between_se3 import between_linearize, between_linearize_plain
from theseus_tpu_torch.sparse.assemble import assemble
from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
from theseus_tpu_torch.sparse.cholesky import factorize, solve_with_factor
from theseus_tpu_torch.sparse.level_kernels import (
    level_bwd_subst,
    level_bwd_subst_plain,
    level_factor,
    level_factor_plain,
    level_fwd_subst,
    level_fwd_subst_plain,
)
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.utils.examples.pose_graph import (
    build_pgo_objective,
    pose_values,
    synthetic_pose_graph,
)

pytestmark = pytest.mark.cuda

# (atol, rtol) per dtype for one kernel call against its twin
TOL = {torch.float32: (2e-5, 2e-5), torch.float64: (1e-11, 1e-11)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(a, b, dtype, scale=1.0):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(a, b, atol=atol * scale, rtol=rtol)


def _poses(rng, shape, scale, dtype, device):
    return se3.exp(torch.as_tensor(scale * rng.standard_normal(shape + (6,)))).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_between_kernel_matches_twin(cuda_device, dtype):
    rng = np.random.default_rng(0)
    K, B = 37, 5
    v1 = _poses(rng, (K, B), 1.0, dtype, cuda_device)
    v2 = _poses(rng, (K, B), 1.0, dtype, cuda_device)
    # measurements close to v1^-1 v2 (the near-zero branches) and far from
    # it; one edge at a rotation of pi - 1e-4 (the near-pi branch)
    d = se3.compose(se3.inverse(v1), v2)
    meas = se3.compose(d, _poses(rng, (K, B), 1e-3, dtype, cuda_device))
    meas[: K // 2] = _poses(rng, (K // 2, B), 1.0, dtype, cuda_device)
    w = torch.zeros(B, 6, dtype=torch.float64)
    w[:, 3] = np.pi - 1e-4
    meas[-1] = se3.compose(d[-1], se3.inverse(se3.exp(w).to(dtype).to(cuda_device)))
    _cuda.reset_launches()
    got = between_linearize(v1, v2, meas)
    assert _cuda.launches["between_se3"] == 1
    want = between_linearize_plain(v1, v2, meas)
    torch.cuda.synchronize()
    # f32: atan2 and summation order; near pi the log loses digits in both
    for g, w_ in zip(got, want):
        _close(g, w_, dtype, scale=50.0 if dtype == torch.float32 else 1.0)


def test_between_kernel_shared_measurement(cuda_device):
    rng = np.random.default_rng(1)
    K, B = 9, 4
    v1 = _poses(rng, (K, B), 1.0, torch.float64, cuda_device)
    v2 = _poses(rng, (K, B), 1.0, torch.float64, cuda_device)
    meas = _poses(rng, (B,), 1.0, torch.float64, cuda_device)  # shared by all edges
    got = between_linearize(v1, v2, meas)
    want = between_linearize_plain(v1, v2, meas.expand(v1.shape))
    for g, w_ in zip(got, want):
        _close(g, w_, torch.float64)


def _pgo_normal(n_poses, batch, dtype, device, seed=0):
    gt, edges, meas, init = synthetic_pose_graph(n_poses, batch, seed=seed, dtype=dtype, device=device)
    obj, _ = build_pgo_objective(n_poses, edges, meas, gt[0], dtype=dtype, device=device)
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    state, aux = co.pack(values, batch), co.build_aux(values, batch)
    bld = SparseNormalBuilder(co)
    with config.plain_path():
        blocks = co.linearize_blocks(state, aux)
    return bld, blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assemble_kernel_matches_twin(cuda_device, dtype):
    bld, blocks = _pgo_normal(40, 6, dtype, cuda_device)
    _cuda.reset_launches()
    ata, atb = assemble_blocks(bld.pattern, blocks)
    assert _cuda.launches["assemble_blocks"] == 1
    ata_p, atb_p = assemble_blocks_plain(bld.pattern, blocks)
    scale = float(ata_p.abs().max())
    _close(ata, ata_p, dtype, scale)
    _close(atb, atb_p, dtype, float(atb_p.abs().max()))
    # owner-computes: bitwise the same on a second run
    ata2, atb2 = assemble_blocks(bld.pattern, blocks)
    assert torch.equal(ata, ata2) and torch.equal(atb, atb2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_level_kernels_match_twins(cuda_device, dtype):
    bld, blocks = _pgo_normal(64, 8, dtype, cuda_device)
    with config.plain_path():
        ata, atb = assemble(bld.pattern, blocks)
        lflat_p = factorize(bld.sched, ata)
        x_p = solve_with_factor(bld.sched, lflat_p, atb)
    _cuda.reset_launches()
    lflat = factorize(bld.sched, ata)
    x = solve_with_factor(bld.sched, lflat, atb)
    n_levels = len(bld.sched.level_tables)
    assert _cuda.launches["level_factor"] == n_levels
    assert _cuda.launches["level_fwd_subst"] == n_levels
    assert _cuda.launches["level_bwd_subst"] == n_levels
    torch.cuda.synchronize()
    _close(lflat, lflat_p, dtype, float(lflat_p.abs().max()))
    _close(x, x_p, dtype, 10.0 * float(x_p.abs().max()))


def test_level_kernels_ragged_shapes(cuda_device):
    """Direct calls at shapes no PGO level has: ul, rl > 3, d = 3 and 8."""
    rng = np.random.default_rng(2)
    for d in (3, 8):
        C, ul, rl, B = 5, 7, 6, 33
        dt = torch.float64
        t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dt, device=cuda_device)  # noqa: E731
        col_a = t(C, rl, B, d, d)
        spd = t(C, B, d, d)
        col_a[:, 0] = spd @ spd.transpose(-1, -2) + 50.0 * torch.eye(d, dtype=dt, device=cuda_device)
        ks, kj = 0.1 * t(C, ul, rl, B, d, d), 0.1 * t(C, ul, B, d, d)
        _close(level_factor(col_a, ks, kj), level_factor_plain(col_a, ks, kj), dt, 10.0)
        lower = torch.tril(t(C, B, d, d)) + 5.0 * torch.eye(d, dtype=dt, device=cuda_device)
        ljk, yk, b = t(C, ul, B, d, d), t(C, ul, B, d), t(C, B, d)
        _close(level_fwd_subst(ljk, yk, b, lower), level_fwd_subst_plain(ljk, yk, b, lower), dt, 10.0)
        lcol = t(C, rl, B, d, d)
        lcol[:, 0] = lower
        xr = t(C, rl, B, d)
        _close(level_bwd_subst(lcol, xr, b), level_bwd_subst_plain(lcol, xr, b), dt, 10.0)


def test_level_factor_nonpositive_pivot_is_nan(cuda_device):
    d, B = 6, 4
    col_a = -torch.eye(d, dtype=torch.float32, device=cuda_device).expand(1, 1, B, d, d).contiguous()
    ks = torch.zeros(1, 1, 1, B, d, d, device=cuda_device)
    kj = torch.zeros(1, 1, B, d, d, device=cuda_device)
    out = level_factor(col_a, ks, kj)
    assert torch.isnan(out[0, 0, :, 0, 0]).all()


def test_kernels_reject_other_dtypes_and_wide_blocks(cuda_device):
    v = se3.identity(2, 3, dtype=torch.float16, device=cuda_device).contiguous()
    with pytest.raises(TypeError):
        between_linearize(v, v, v)
    d = 9
    col_a = torch.zeros(1, 1, 2, d, d, device=cuda_device)
    with pytest.raises(ValueError):
        level_factor(col_a, torch.zeros(1, 1, 1, 2, d, d, device=cuda_device),
                     torch.zeros(1, 1, 2, d, d, device=cuda_device))


def test_lm_solve_on_card_matches_cpu_twins(cuda_device):
    import theseus_tpu_torch as tt

    n, b = 24, 4
    results = {}
    for dev in ("cpu", cuda_device):
        gt, edges, meas, init = synthetic_pose_graph(n, b, seed=3, dtype=torch.float64, device=dev)
        obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=torch.float64, device=dev)
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True))
        _cuda.reset_launches()
        _, info = layer.forward(pose_values(init))
        results[str(dev)] = info.last_err.cpu()
        if dev != "cpu":
            assert all(v > 0 for v in _cuda.launches.values()), _cuda.launches
    # f64 converged plateau: kernels and twins differ only in rounding order
    torch.testing.assert_close(results["cuda"], results["cpu"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("high_precision", [False, True])
def test_run_scan_never_syncs_with_the_host(cuda_device, high_precision):
    """The fixed-length LM loop queues work and never waits for the card:
    torch's sync debug mode turns any synchronizing call inside it into an
    error (a copy from pageable host memory, .item(), a blocking read)."""
    import theseus_tpu_torch as tt

    gt, edges, meas, init = synthetic_pose_graph(32, 8, seed=4, dtype=torch.float32, device=cuda_device)
    obj, _ = build_pgo_objective(32, edges, meas, gt[0], dtype=torch.float32, device=cuda_device)
    opt = tt.LevenbergMarquardt(obj, max_iterations=3, adaptive_damping=True)
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    state, aux = co.pack(values, 8), co.build_aux(values, 8)
    config.set_high_precision_tier(high_precision)
    try:
        with torch.no_grad():
            carry = opt.init_carry(state, aux, opt.opts)
            carry = opt.run_scan(carry, aux, 1, opt.opts)  # builds the library and device tables
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                carry = opt.run_scan(carry, aux, 3, opt.opts)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        config.set_high_precision_tier(False)
    assert torch.isfinite(carry["err"]).all()
