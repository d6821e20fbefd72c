"""CUDA kernels of theseus_tpu_torch against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc; without a card each skips
(decided inside the `cuda_device` fixture, never at import). This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float64 kernels agree with their twins to ~1e-12 (same
formulas, different summation order and FMA contraction); float32 to a few
ulp of the operands' magnitude, stated per test.
"""

import contextlib

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
from theseus_tpu_torch.ops.reprojection import reprojection_linearize, reprojection_linearize_plain
from theseus_tpu_torch.optim import LevenbergMarquardt
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective, synthetic_ba
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


def _pgo_normal(n_poses, batch, dtype, device, seed=0, clique=0):
    """clique > 0 also joins `clique` poses spread along the chain all to
    all: the first of them eliminated has a factor column of at least
    `clique` block rows."""
    gt, edges, meas, init = synthetic_pose_graph(n_poses, batch, seed=seed, dtype=dtype, device=device)
    if clique:
        hub = list(range(0, n_poses, n_poses // clique))[:clique]
        extra = [(i, j) for i in hub for j in hub if i < j and (i, j) not in set(map(tuple, edges))]
        e = torch.as_tensor(extra)
        meas = torch.cat([meas, se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])])
        edges = list(edges) + extra
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C,ul,B", [(1, 17, 128), (32, 1, 128), (3, 40, 7), (2, 400, 3)])
def test_level_fwd_subst_repeatable_and_matches_twin(cuda_device, dtype, C, ul, B):
    """The PGO 256 x 128 deepest level (1, 17) and widest (32, 1), a list
    longer than a warp's lanes, and one longer than 48 KB of shared memory
    holds (staged in chunks, fwd_subst_geometry): two launches give the same
    bits (the update list is summed in a fixed tree), within tolerance of
    the twin."""
    rng = np.random.default_rng(7)
    d = 6
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=cuda_device)  # noqa: E731
    ljk, yk, b = t(C, ul, B, d, d), t(C, ul, B, d), t(C, B, d)
    ldiag = torch.tril(t(C, B, d, d)) + 4.0 * torch.eye(d, dtype=dtype, device=cuda_device)
    _cuda.reset_launches()
    y1 = level_fwd_subst(ljk, yk, b, ldiag)
    y2 = level_fwd_subst(ljk, yk, b, ldiag)
    assert _cuda.launches["level_fwd_subst"] == 2
    want = level_fwd_subst_plain(ljk, yk, b, ldiag)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    _close(y1, want, dtype, float(want.abs().max()))


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
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True,
                                                      linearization="sparse"))
        _cuda.reset_launches()
        _, info = layer.forward(pose_values(init))
        results[str(dev)] = info.last_err.cpu()
        if dev != "cpu":
            pgo = ("between_se3", "assemble_blocks", "level_factor", "level_fwd_subst", "level_bwd_subst")
            assert all(_cuda.launches[k] > 0 for k in pgo), _cuda.launches
            assert _cuda.launches["reprojection"] == 0
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
    opt = tt.LevenbergMarquardt(obj, max_iterations=3, adaptive_damping=True, linearization="sparse")
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


def _reprojection_inputs(rng, K, B, dtype, device, shared=False):
    pose = _poses(rng, (K, B), 0.2, dtype, device)
    p_cam = torch.as_tensor(rng.uniform(-1.0, 1.0, (K, B, 3)) + [0.0, 0.0, 5.0], dtype=dtype, device=device)
    r, t = pose[..., :3], pose[..., 3]
    point = (r.transpose(-1, -2) @ (p_cam - t)[..., None])[..., 0]  # R^T (P - t)
    kshape = (B, 1) if shared else (K, B, 1)
    t_ = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (pose, point, t_(1000.0 + 50.0 * rng.standard_normal(kshape)),
            t_(200.0 * rng.standard_normal((K, B, 2))), t_(0.1 * rng.standard_normal(kshape)),
            t_(0.01 * rng.standard_normal(kshape)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
def test_reprojection_kernel_matches_twin(cuda_device, dtype, shared):
    """Relative to max(1, |twin|): outputs carry the focal length (~1e3)."""
    args = _reprojection_inputs(np.random.default_rng(0), 301, 7, dtype, cuda_device, shared)
    _cuda.reset_launches()
    got = reprojection_linearize(*args)
    assert _cuda.launches["reprojection"] == 1
    with config.plain_path():
        want = reprojection_linearize(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g, w, dtype, float(w.abs().max()))


def test_reprojection_kernel_point_on_camera_plane_is_not_finite(cuda_device):
    args = list(_reprojection_inputs(np.random.default_rng(1), 4, 2, torch.float64, cuda_device))
    args[0][0, 0] = torch.eye(3, 4, dtype=torch.float64, device=cuda_device)
    args[1][0, 0] = torch.tensor([0.3, -0.2, 0.0], dtype=torch.float64, device=cuda_device)
    got = reprojection_linearize(*args)
    want = reprojection_linearize_plain(*args)
    for g, w in zip(got, want):
        assert not torch.isfinite(g[0, 0]).all() and not torch.isfinite(w[0, 0]).all()
        _close(g[1:], w[1:], torch.float64, float(w[1:].abs().max()))


def _ba_layer(device, dtype, cams=8, pts=60, batch=3, iters=15):
    prob = synthetic_ba(cams, pts, batch=batch, seed=2, visibility=0.5, dtype=dtype, device=device)
    obj, _, _ = build_ba_objective(prob, dtype=dtype, device=device)
    opt = LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True,
                             ellipsoidal_damping=True, linearization="schur")
    return opt, obj, ba_values(prob)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assemble_kernel_matches_twin_at_mixed_dof(cuda_device, dtype):
    """The BA buckets: camera jacobians (2 x 6) and point jacobians padded
    from 2 x 3 to d = 6."""
    from theseus_tpu_torch.sparse.assemble import _pad_jac

    opt, obj, vals = _ba_layer(cuda_device, dtype)
    co = obj.compile()
    state, aux = co.pack(vals), co.build_aux(vals)
    pattern = opt.normal_builder.pattern
    with config.plain_path():
        blocks = co.linearize_blocks(state, aux)
    padded = [([_pad_jac(j, pattern.d) for j in jacs], err) for jacs, err in blocks]
    ata, atb = assemble_blocks(pattern, padded)
    ata_p, atb_p = assemble_blocks_plain(pattern, padded)
    _close(ata, ata_p, dtype, float(ata_p.abs().max()))
    _close(atb, atb_p, dtype, float(atb_p.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3])
def test_assemble_kernel_split_lists(cuda_device, dtype, batch):
    """Camera lists of ~100 items, split into 13 chunks (B = 1: a warp per
    output; B = 3: a block per output, batch tile 4 with one lane idle),
    against the twin and bitwise repeatable over two launches."""
    from theseus_tpu_torch.sparse.assemble import _pad_jac

    opt, obj, vals = _ba_layer(cuda_device, dtype, cams=8, pts=200, batch=batch)
    co = obj.compile()
    state, aux = co.pack(vals), co.build_aux(vals)
    pattern = opt.normal_builder.pattern
    assert len(pattern.asm_tables.split) > 0
    with config.plain_path():
        blocks = co.linearize_blocks(state, aux)
    padded = [([_pad_jac(j, pattern.d) for j in jacs], err) for jacs, err in blocks]
    _cuda.reset_launches()
    ata, atb = assemble_blocks(pattern, padded)
    ata2, atb2 = assemble_blocks(pattern, padded)
    assert _cuda.launches["assemble_blocks"] == 2
    ata_p, atb_p = assemble_blocks_plain(pattern, padded)
    torch.cuda.synchronize()
    assert torch.equal(ata, ata2) and torch.equal(atb, atb2)
    _close(ata, ata_p, dtype, float(ata_p.abs().max()))
    _close(atb, atb_p, dtype, float(atb_p.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_poses,batch,variant", [(64, 16, "shared"), (4400, 1, "device")])
def test_level_factor_bit_equal_to_whole_factor(cuda_device, dtype, n_poses, batch, variant):
    """Both kernels form each entry's update in the same order (u outer, k
    inner, from zero) and run the same POTRF and TRSM statements, whether
    the whole factor is built in shared or in device memory."""
    from theseus_tpu_torch.sparse.cholesky import factorize_levels
    from theseus_tpu_torch.sparse.whole import whole_factor, whole_factor_variant

    bld, ata, _ = _whole_system(n_poses, batch, dtype, cuda_device)
    assert whole_factor_variant(bld.sched, ata.shape[-1], ata.element_size()) == variant
    _cuda.reset_launches()
    lflat_l = factorize_levels(bld.sched, ata)
    lflat_w = whole_factor(bld.sched, ata)
    torch.cuda.synchronize()
    assert _cuda.launches["level_factor"] == len(bld.sched.level_tables)
    assert _cuda.launches["whole_factor"] == 1
    assert bool(torch.isfinite(lflat_l).all())
    assert float((lflat_l - lflat_w).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_poses,batch,variant", [(48, 4, "shared"), (1200, 2, "device")])
def test_whole_factor_long_columns(cuda_device, dtype, n_poses, batch, variant):
    """Nine poses joined all to all give a column of nine block rows or
    more, so its TRSM has more items ((rows - 1) d = 48 at d = 6) than a
    warp has lanes: the kernel runs the items beyond 32 after the POTRF.
    Bit-equal to the level factor and within tolerance of the twin, in
    both variants."""
    from theseus_tpu_torch.sparse.cholesky import factorize_levels
    from theseus_tpu_torch.sparse.whole import get_tables, whole_factor, whole_factor_variant

    bld, ata, _ = _whole_system(n_poses, batch, dtype, cuda_device, clique=9)
    d = ata.shape[-1]
    assert whole_factor_variant(bld.sched, d, ata.element_size()) == variant
    assert (int(get_tables(bld.sched).host["fact_lvl"][:, 2].max()) - 1) * d > 32
    _cuda.reset_launches()
    lflat_l = factorize_levels(bld.sched, ata)
    lflat_w = whole_factor(bld.sched, ata)
    assert _cuda.launches["whole_factor"] == 1
    with config.plain_path():
        lflat_p = whole_factor(bld.sched, ata)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(lflat_w).all())
    assert float((lflat_l - lflat_w).abs().max()) == 0.0
    _close(lflat_w, lflat_p, dtype, float(lflat_p.abs().max()))


def test_ba_schur_solve_on_card_matches_cpu_twins(cuda_device):
    import theseus_tpu_torch as tt

    results = {}
    for dev in ("cpu", cuda_device):
        opt, _, vals = _ba_layer(dev, torch.float64)
        _cuda.reset_launches()
        _, info = tt.TheseusLayer(opt).forward(vals)
        results[str(dev)] = info.last_err.cpu()
        if dev != "cpu":
            assert _cuda.launches["reprojection"] == 2 * 15 + 1
            assert _cuda.launches["assemble_blocks"] == 15
    torch.testing.assert_close(results["cuda"], results["cpu"], rtol=1e-9, atol=1e-12)


def test_schur_run_scan_never_syncs_with_the_host(cuda_device):
    opt, obj, vals = _ba_layer(cuda_device, torch.float32, iters=3)
    co = obj.compile()
    values = obj.default_values(vals)
    state, aux = co.pack(values), co.build_aux(values)
    with torch.no_grad():
        carry = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, 1, opt.opts)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry = opt.run_scan(carry, aux, 3, opt.opts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(carry["err"]).all()


# ---------------------------------------------------------------------------
# whole-sweep kernels (sparse/whole.py) and the backward on the card
# ---------------------------------------------------------------------------
def _whole_system(n_poses, batch, dtype, device, clique=0):
    from theseus_tpu_torch.sparse.assemble import apply_block_damping

    bld, blocks = _pgo_normal(n_poses, batch, dtype, device, clique=clique)
    with config.plain_path():
        ata, atb = assemble(bld.pattern, blocks)
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    return bld, ata, atb


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_poses,batch", [(40, 6), (4400, 1)])
def test_whole_kernels_match_twins(cuda_device, dtype, n_poses, batch):
    """Factor slot for slot against the per-column twin and the level plan;
    both substitutions against their twins. At 40 poses the factor is built
    in shared memory, at 4400 in device memory; there the float64 vector
    (4400 x 6 x 8 bytes) exceeds the shared-memory budget too, so the
    substitutions work in device memory."""
    from theseus_tpu_torch.sparse.cholesky import factorize_levels
    from theseus_tpu_torch.sparse.whole import (
        whole_bwd_subst, whole_factor, whole_factor_variant, whole_fwd_subst)

    bld, ata, atb = _whole_system(n_poses, batch, dtype, cuda_device)
    sched = bld.sched
    assert whole_factor_variant(sched, ata.shape[-1], ata.element_size()) == (
        "shared" if n_poses == 40 else "device")
    _cuda.reset_launches()
    lflat = whole_factor(sched, ata)
    y = whole_fwd_subst(sched, lflat, atb)
    x = whole_bwd_subst(sched, lflat, y)
    assert [_cuda.launches[k] for k in ("whole_factor", "whole_fwd_subst", "whole_bwd_subst")] == [1, 1, 1]
    with config.plain_path():
        lflat_p = whole_factor(sched, ata)
        y_p = whole_fwd_subst(sched, lflat, atb)
        x_p = whole_bwd_subst(sched, lflat, y_p)
    lflat_l = factorize_levels(sched, ata)
    torch.cuda.synchronize()
    assert float(lflat[0].abs().max()) == 0.0
    scale = float(lflat_p.abs().max())
    _close(lflat, lflat_p, dtype, scale)
    _close(lflat, lflat_l, dtype, scale)
    _close(y, y_p, dtype, float(y_p.abs().max()))
    _close(x, x_p, dtype, 10.0 * float(x_p.abs().max()))


def test_whole_factor_nonpositive_pivot_is_nan(cuda_device):
    from theseus_tpu_torch.sparse.whole import whole_factor

    bld, ata, _ = _whole_system(16, 3, torch.float32, cuda_device)
    ata = ata.clone()
    ata[1:, 1] = -ata[1:, 1].abs()  # batch element 1: negative diagonal blocks
    lflat = whole_factor(bld.sched, ata)
    assert torch.isnan(lflat[1:, 1]).any() and bool(torch.isfinite(lflat[:, 0]).all())


def test_between_fused_entry_matches_twin(cuda_device):
    from theseus_tpu_torch.ops.between_se3 import between_linearize_fused

    rng = np.random.default_rng(5)
    K, B = 257, 9
    v1, v2, meas = (_poses(rng, (K, B), 1.0, torch.float64, cuda_device) for _ in range(3))
    _cuda.reset_launches()
    got = between_linearize_fused(v1, v2, meas)
    assert _cuda.launches["between_se3_aos"] == 1 and _cuda.launches["between_se3"] == 0
    for g, w in zip(got, between_linearize_plain(v1, v2, meas)):
        _close(g, w, torch.float64)


def _training_grad(device, dtype, mode, whole, n=32, b=8, iters=20, cls=None):
    """Outer loss and d loss / d theta of the flagship training step."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local, training_weights

    gt, edges, meas, init = synthetic_pose_graph(n, b, seed=6, dtype=dtype, device=device)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=dtype, device=device,
                                 edge_weight=w_odo, loop_weight=w_loop)
    opt = (cls or tt.LevenbergMarquardt)(obj, max_iterations=iters, linearization="sparse",
                                         **({} if cls else {"adaptive_damping": True}))
    theta = torch.tensor(1.3, dtype=dtype, device=device, requires_grad=True)
    inputs = dict(pose_values(init), w_loop=theta.reshape(1, 1))
    config.set_whole_sweep(whole)
    try:
        out, _ = tt.TheseusLayer(opt).forward(inputs, optimizer_kwargs={"backward_mode": mode})
        loss = mean_sq_local(out, gt)
        before = dict(_cuda.launches)
        loss.backward()
        during = {k: _cuda.launches[k] - before[k] for k in before}
    finally:
        config.set_whole_sweep(False)
    return float(loss.detach()), float(theta.grad), before, during


@pytest.mark.parametrize("mode", ["implicit", "unroll"])
def test_training_gradient_on_card_matches_twins(cuda_device, mode):
    """float64 on the card: the kernels' gradient equals the plain twins'
    (whole-sweep and level plans) to rounding order; the implicit backward
    launches one substitution pair and no factorization."""
    import theseus_tpu_torch as tt

    kw = {"cls": tt.GaussNewton, "iters": 6} if mode == "unroll" else {}
    _cuda.reset_launches()
    loss, grad, fwd, bwd = _training_grad(cuda_device, torch.float64, mode, True, **kw)
    assert fwd["level_factor"] == 0 and fwd["whole_factor"] > 0
    if mode == "implicit":
        assert bwd["whole_factor"] == 0
        assert bwd["whole_fwd_subst"] == 1 and bwd["whole_bwd_subst"] == 1
    with config.plain_path():
        loss_p, grad_p, _, _ = _training_grad(cuda_device, torch.float64, mode, False, **kw)
    _, grad_l, _, _ = _training_grad(cuda_device, torch.float64, mode, False, **kw)
    assert np.isfinite(grad) and grad != 0.0
    np.testing.assert_allclose(loss, loss_p, rtol=1e-9)
    np.testing.assert_allclose(grad, grad_p, rtol=1e-7)
    np.testing.assert_allclose(grad, grad_l, rtol=1e-7)


def test_whole_sweep_run_scan_never_syncs_with_the_host(cuda_device):
    import theseus_tpu_torch as tt

    gt, edges, meas, init = synthetic_pose_graph(32, 8, seed=4, dtype=torch.float32, device=cuda_device)
    obj, _ = build_pgo_objective(32, edges, meas, gt[0], dtype=torch.float32, device=cuda_device)
    opt = tt.LevenbergMarquardt(obj, max_iterations=3, adaptive_damping=True, linearization="sparse")
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    state, aux = co.pack(values, 8), co.build_aux(values, 8)
    config.set_whole_sweep(True)
    try:
        with torch.no_grad():
            carry = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, 1, opt.opts)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                carry = opt.run_scan(carry, aux, 3, opt.opts)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        config.set_whole_sweep(False)
    assert torch.isfinite(carry["err"]).all()


# ---------------------------------------------------------------------------
# the redesigned Between kernel and whole forward sweep, and the dense tail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_between_kernel_blocks_ragged_and_repeatable(cuda_device, dtype, threads):
    """Every block size the geometry picks, each at a K B just above the
    card's block floor times that size (so the geometry picks it) and a
    multiple of no block size: against the twin and bitwise repeatable;
    once with a measurement shared by all edges (stride 0)."""
    from theseus_tpu_torch.ops import between_se3 as bmod

    min_blocks = _cuda.tile_min_blocks(torch.cuda.current_device())
    K, B = min_blocks * threads // 127 + 1, 127
    assert bmod.between_geometry(K * B, torch.empty((), dtype=dtype).element_size(), min_blocks)[0] == threads
    assert (K * B) % threads
    rng = np.random.default_rng(threads)
    v1 = _poses(rng, (K, B), 1.0, dtype, cuda_device)
    v2 = _poses(rng, (K, B), 1.0, dtype, cuda_device)
    for meas in (se3.compose(se3.compose(se3.inverse(v1), v2), _poses(rng, (K, B), 0.3, dtype, cuda_device)),
                 _poses(rng, (B,), 1.0, dtype, cuda_device)):
        _cuda.reset_launches()
        got = between_linearize(v1, v2, meas)
        again = between_linearize(v1, v2, meas)
        assert _cuda.launches["between_se3"] == 2
        want = between_linearize_plain(v1, v2, meas.expand(v1.shape))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # up to 67,691 random edges: some sit where jlog's coefficients cancel
        # (chip_smoke.py KERNEL_TOL: 2e-3 in float32, 1e-10 in float64)
        for g, w_ in zip(got, want):
            _close(g, w_, dtype, scale=50.0 if dtype == torch.float32 else 10.0)


def _whole_fwd_pair(bld, ata, atb):
    """(whole_fwd_subst, the level forward sweep) on the level kernels' factor."""
    from theseus_tpu_torch.sparse.cholesky import factorize_levels, forward_sweep
    from theseus_tpu_torch.sparse.whole import whole_fwd_subst

    lflat = factorize_levels(bld.sched, ata)
    perm, _, _ = bld.sched.on(atb.device)
    _cuda.reset_launches()
    y_w = whole_fwd_subst(bld.sched, lflat, atb)
    y_w2 = whole_fwd_subst(bld.sched, lflat, atb)
    y_l = forward_sweep(bld.sched, lflat, atb[perm])
    torch.cuda.synchronize()
    assert _cuda.launches["whole_fwd_subst"] == 2
    assert torch.equal(y_w, y_w2)
    return y_w, y_l


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_poses,batch,clique", [(64, 16, 0), (256, 128, 0), (2048, 8, 0), (48, 4, 9)])
def test_whole_fwd_subst_bit_equal_to_level_sweep(cuda_device, dtype, n_poses, batch, clique):
    """Both sum each output's update list over the level's gu lanes in one
    order and add the lanes in one tree, then run the same solve: the same
    bits, at the PGO shapes (2048 x 8 cut into stages) and on the 9-pose
    clique."""
    bld, ata, atb = _whole_system(n_poses, batch, dtype, cuda_device, clique=clique)
    y_w, y_l = _whole_fwd_pair(bld, ata, atb)
    assert bool(torch.isfinite(y_w).all())
    assert float((y_w - y_l).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_whole_fwd_subst_pieces(cuda_device, dtype, monkeypatch):
    """A 40-pose clique (dense tail off) has update lists of up to 39: with
    a budget of 14 KiB (float32) or 26 KiB (float64) they are staged in
    pieces of 32, with the full budget in whole columns. Each bit-equal to
    the level sweep."""
    from theseus_tpu_torch.sparse import whole

    config.set_sparse_dense_tail(False)
    try:
        bld, ata, atb = _whole_system(64, 5, dtype, cuda_device, clique=40)
    finally:
        config.set_sparse_dense_tail(True)
    small = (14 if dtype == torch.float32 else 26) * 1024
    for budget in (small, whole.WHOLE_SUBST_SMEM_MAX):
        monkeypatch.setattr(whole, "WHOLE_SUBST_SMEM_MAX", budget)
        bld.sched._whole_tables = None
        plan = whole.get_tables(bld.sched).fwd_plan(6, ata.element_size())
        cut = any(not first or not last for _, first, last, _ in plan.stages)
        assert cut == (budget < 32 * 1024)
        y_w, y_l = _whole_fwd_pair(bld, ata, atb)
        assert float((y_w - y_l).abs().max()) == 0.0


def _grid_layer(device, dtype, rows=6, cols=6, batch=3, iters=15, seed=8):
    """A rows x cols grid PGO (snake-numbered chain plus the vertical edges):
    the symbolic analysis gives it a dense tail."""
    import theseus_tpu_torch as tt

    at = lambda i, j: i * cols + (j if i % 2 == 0 else cols - 1 - j)  # noqa: E731
    n = rows * cols
    vertical = [(min(at(i, j), at(i + 1, j)), max(at(i, j), at(i + 1, j)))
                for i in range(rows - 1) for j in range(cols)]
    edges = [(k, k + 1) for k in range(n - 1)] + [e for e in vertical if e[1] - e[0] > 1]
    rng = np.random.default_rng(seed)
    gt = se3.exp(torch.as_tensor(0.5 * rng.standard_normal((n, batch, 6))))
    e = torch.as_tensor(edges)
    meas = se3.compose(se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]]),
                       se3.exp(torch.as_tensor(0.05 * rng.standard_normal((len(edges), batch, 6)))))
    init = se3.compose(gt, se3.exp(torch.as_tensor(0.2 * rng.standard_normal((n, batch, 6)))))
    obj, _ = build_pgo_objective(n, edges, meas.to(dtype), gt[0].to(dtype), dtype=dtype, device=device)
    opt = tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization="sparse")
    assert opt.normal_builder.sched.tail_k > 0 and opt.normal_builder.sched.n_head > 0
    return opt, obj, pose_values(init.to(dtype).to(device))


def test_tail_lm_solve_on_card_matches_cpu_twins(cuda_device):
    """The 6 x 6 grid: the head through the level kernels, the tail's
    update through `tail_update` and its factor through cholesky_ex, one
    of each a factorization, float64, against the CPU twins."""
    import theseus_tpu_torch as tt

    results = {}
    for dev in ("cpu", cuda_device):
        opt, _, vals = _grid_layer(dev, torch.float64)
        _cuda.reset_launches()
        _, info = tt.TheseusLayer(opt).forward(vals)
        results[str(dev)] = info.last_err.cpu()
        if dev != "cpu":
            n_levels = len(opt.normal_builder.sched.level_tables)
            assert _cuda.launches["level_factor"] == 15 * n_levels
            assert _cuda.launches["tail_update"] == 15
            assert _cuda.launches["whole_factor"] == 0
    torch.testing.assert_close(results["cuda"], results["cpu"], rtol=1e-9, atol=1e-12)


def test_tail_run_scan_never_syncs_with_the_host(cuda_device):
    opt, obj, vals = _grid_layer(cuda_device, torch.float32, iters=3)
    co = obj.compile()
    values = obj.default_values(vals)
    state, aux = co.pack(values, 3), co.build_aux(values, 3)
    with torch.no_grad():
        carry = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, 1, opt.opts)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry = opt.run_scan(carry, aux, 3, opt.opts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(carry["err"]).all()


# ---------------------------------------------------------------------------
# the redesigned Reprojection kernel and whole backward sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_reprojection_kernel_blocks_ragged_and_repeatable(cuda_device, dtype, threads):
    """Every block size the geometry picks, each at a K B just above the
    card's block floor times that size and a multiple of no block size:
    against the twin (relative to max(1, |twin|): outputs carry the focal
    length) and bitwise repeatable, with stacked and with shared aux."""
    from theseus_tpu_torch.ops.reprojection import reprojection_geometry

    min_blocks = _cuda.tile_min_blocks(torch.cuda.current_device())
    K, B = min_blocks * threads // 127 + 1, 127
    assert reprojection_geometry(K * B, torch.empty((), dtype=dtype).element_size(), min_blocks)[0] == threads
    assert (K * B) % threads
    for shared in (False, True):
        args = _reprojection_inputs(np.random.default_rng(threads), K, B, dtype, cuda_device, shared)
        _cuda.reset_launches()
        got = reprojection_linearize(*args)
        again = reprojection_linearize(*args)
        assert _cuda.launches["reprojection"] == 2
        with config.plain_path():
            want = reprojection_linearize(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for g, w in zip(got, want):
            _close(g, w, dtype, max(1.0, float(w.abs().max())))


def _whole_bwd_pair(bld, ata, atb):
    """(whole_bwd_subst, the level backward sweep in the original order) on
    the level kernels' factor and forward sweep."""
    from theseus_tpu_torch.sparse.cholesky import backward_sweep, factorize_levels, forward_sweep
    from theseus_tpu_torch.sparse.whole import whole_bwd_subst

    lflat = factorize_levels(bld.sched, ata)
    perm, iperm, _ = bld.sched.on(atb.device)
    y = forward_sweep(bld.sched, lflat, atb[perm])
    _cuda.reset_launches()
    x_w = whole_bwd_subst(bld.sched, lflat, y)
    x_w2 = whole_bwd_subst(bld.sched, lflat, y)
    x_l = backward_sweep(bld.sched, lflat, y)[iperm]
    torch.cuda.synchronize()
    assert _cuda.launches["whole_bwd_subst"] == 2
    assert torch.equal(x_w, x_w2)
    return x_w, x_l


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_poses,batch,clique", [(64, 16, 0), (256, 128, 0), (2048, 8, 0), (48, 4, 9)])
def test_whole_bwd_subst_bit_equal_to_level_sweep(cuda_device, dtype, n_poses, batch, clique):
    """Both run each output's chain over the column's rows in one order and
    the same transposed solve: the same bits, at the PGO shapes (2048 x 8
    cut into stages) and on the 9-pose clique (columns of up to 10 rows)."""
    bld, ata, atb = _whole_system(n_poses, batch, dtype, cuda_device, clique=clique)
    x_w, x_l = _whole_bwd_pair(bld, ata, atb)
    assert bool(torch.isfinite(x_w).all())
    assert float((x_w - x_l).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_whole_bwd_subst_pieces_and_device_x(cuda_device, dtype, monkeypatch):
    """A 40-pose clique (dense tail off) has columns of up to 41 rows: with
    a budget of 14 KiB (float32) or 26 KiB (float64) they are staged in
    pieces, with the full budget whole; and 2048 x 8 under a budget below
    its x keeps x in device memory. Each bit-equal to the level sweep."""
    from theseus_tpu_torch.sparse import whole

    config.set_sparse_dense_tail(False)
    try:
        bld, ata, atb = _whole_system(64, 5, dtype, cuda_device, clique=40)
    finally:
        config.set_sparse_dense_tail(True)
    small = (14 if dtype == torch.float32 else 26) * 1024
    for budget in (small, whole.WHOLE_SUBST_SMEM_MAX):
        monkeypatch.setattr(whole, "WHOLE_SUBST_SMEM_MAX", budget)
        bld.sched._whole_tables = None
        plan = whole.get_tables(bld.sched).bwd_plan(6, ata.element_size())
        cut = any(not first or not last for _, first, last, _ in plan.stages)
        assert cut == (budget < 32 * 1024)
        x_w, x_l = _whole_bwd_pair(bld, ata, atb)
        assert float((x_w - x_l).abs().max()) == 0.0
    bld, ata, atb = _whole_system(2048, 8, dtype, cuda_device)
    monkeypatch.setattr(whole, "WHOLE_SUBST_SMEM_MAX", (32 if dtype == torch.float32 else 64) * 1024)
    assert not whole.get_tables(bld.sched).bwd_plan(6, ata.element_size()).vec_smem
    x_w, x_l = _whole_bwd_pair(bld, ata, atb)
    assert float((x_w - x_l).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the redesigned level backward substitution on the grid's head levels
# ---------------------------------------------------------------------------
def _grid_bwd_levels(device, dtype, batch):
    """The backward operands of every head level of the 16 x 16 grid ((C, rl)
    from (118, 5) to (2, 15)), gathered by `bwd_operands` from a plain-twin
    factorization and solve of its LM-damped system."""
    from theseus_tpu_torch.sparse.assemble import apply_block_damping
    from theseus_tpu_torch.sparse.cholesky import backward_sweep, bwd_operands, forward_sweep

    opt, obj, vals = _grid_layer(device, dtype, rows=16, cols=16, batch=batch)
    co = obj.compile()
    values = obj.default_values(vals)
    state, aux = co.pack(values, batch), co.build_aux(values, batch)
    bld = opt.normal_builder
    with config.plain_path():
        ata, atb = assemble(bld.pattern, co.linearize_blocks(state, aux))
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
        lflat = factorize(bld.sched, ata)
        perm, _, levels = bld.sched.on(device)
        y = forward_sweep(bld.sched, lflat, atb[perm])
        x = backward_sweep(bld.sched, lflat, y)
    return [bwd_operands(t, lflat, x, y) for t in levels]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [5, 33])
def test_level_bwd_subst_grid_levels_chunked(cuda_device, dtype, batch, monkeypatch):
    """Each grid head level: two launches bitwise equal and within tolerance
    of the twin; then, with the shared-memory budget cut so that the rows
    are staged one and two at a time (bwd_subst_geometry), the same bits as
    with every row staged at once."""
    from theseus_tpu_torch.sparse import level_kernels as lk

    levels = _grid_bwd_levels(cuda_device, dtype, batch)
    assert max(lcol.shape[1] for lcol, _, _ in levels) == 15
    whole = []
    for lcol, xr, y in levels:
        _cuda.reset_launches()
        x1, x2 = level_bwd_subst(lcol, xr, y), level_bwd_subst(lcol, xr, y)
        assert _cuda.launches["level_bwd_subst"] == 2
        want = level_bwd_subst_plain(lcol, xr, y)
        torch.cuda.synchronize()
        assert torch.equal(x1, x2)
        _close(x1, want, dtype, max(1.0, float(want.abs().max())))
        whole.append(x1)
    isz = torch.empty((), dtype=dtype).element_size()
    for rows in (1, 2):
        for (lcol, xr, y), x_all in zip(levels, whole):
            C, rl, B = lcol.shape[:3]
            sms = _cuda.sm_count(lcol.device.index)
            bt, _ = lk.bwd_subst_geometry(C, rl, B, 6, isz, lk.FWD_BLOCKS_PER_SM * sms)
            monkeypatch.setattr(lk, "FWD_SMEM_MAX", lk.bwd_subst_smem(bt, rows, 6, isz))
            assert lk.bwd_subst_geometry(C, rl, B, 6, isz, lk.FWD_BLOCKS_PER_SM * sms) == (bt, rows)
            got = level_bwd_subst(lcol, xr, y)
            monkeypatch.undo()
            torch.cuda.synchronize()
            assert torch.equal(got, x_all)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reprojection_function_backward_matches_twin_vjp(cuda_device, dtype):
    """The autograd Function on the card: its forward is one kernel launch,
    its backward the VJP of the twin, held against the twin's own autograd
    on the same inputs (float32: the outputs carry the focal length, so the
    gradients are compared relative to their largest entry)."""
    rng = np.random.default_rng(9)
    args = _reprojection_inputs(rng, 97, 5, dtype, cuda_device)
    cots = [torch.as_tensor(rng.standard_normal(s), dtype=dtype, device=cuda_device)
            for s in ((97, 5, 2, 6), (97, 5, 2, 3), (97, 5, 2))]
    leaves = [a.clone().requires_grad_(True) for a in args]
    _cuda.reset_launches()
    got = torch.autograd.grad(reprojection_linearize(*leaves), leaves, cots)
    assert _cuda.launches["reprojection"] == 1
    twin = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(reprojection_linearize_plain(*twin), twin, cots)
    for g, w in zip(got, want):
        _close(g, w, dtype, float(w.abs().max()))


def _robust_ba_grad(device, dtype, mode, plain=False):
    """d loss / d log_radius of a robust (Huber) BA layer, 128 x 200 x
    batch 1, visibility 0.4, 5 % outliers and a scale pin on landmark 0,
    Schur linearization: (loss, grad, launches in forward, launches in
    backward()). 128 cameras: every point is seen by ~50 of them (with
    fewer, points seen by two cameras run away under the Huber loss and
    the undamped float32 solve fails)."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.lie import se3

    prob = synthetic_ba(128, 200, batch=1, seed=2, visibility=0.4, outlier_fraction=0.05, dtype=dtype,
                        device=device)
    log_radius = torch.zeros((1, 1), dtype=dtype, device=device, requires_grad=True)
    obj, _, pts = build_ba_objective(prob, dtype=dtype, device=device, robust_loss_cls=tt.HuberLoss,
                                     log_loss_radius=log_radius, gauge_target=prob.gt_poses[0])
    obj.add(tt.Local(pts[0], prob.gt_points[0].cpu().numpy(), tt.ScaleCostWeight(1e3), name="scale_pin"))
    opt = tt.LevenbergMarquardt(obj, max_iterations=6 if mode == "unroll" else 15, adaptive_damping=True,
                                ellipsoidal_damping=True, linearization="schur")
    with config.plain_path() if plain else contextlib.nullcontext():
        before = dict(_cuda.launches)
        out, _ = tt.TheseusLayer(opt).forward(ba_values(prob), optimizer_kwargs={"backward_mode": mode})
        d = se3.log(se3.compose(se3.inverse(out["cam"]), prob.gt_poses))
        loss = torch.mean(torch.sum(d * d, dim=-1))
        mid = dict(_cuda.launches)
        loss.backward()
    fwd = {k: mid[k] - before[k] for k in mid}
    bwd = {k: _cuda.launches[k] - mid[k] for k in mid}
    return float(loss.detach()), float(log_radius.grad), fwd, bwd


@pytest.mark.parametrize("mode", ["implicit", "unroll", "dlm"])
def test_robust_ba_gradient_on_card_matches_twins(cuda_device, mode):
    """The Schur backward (`_SchurSolve`) and the Reprojection Function on
    the card: float64 kernels equal the float64 plain twins to rounding
    order (1e-7); the float32 kernels' implicit gradient is within 5e-2 of
    them (the float32 plateau, as in chip_smoke.py's training phases). An
    unrolled float32 solve may accept or reject other LM steps, and a
    float32 BA DLM step perturbs the state below float32's resolution, so
    those two are held in float64 only."""
    loss, grad, fwd, bwd = _robust_ba_grad(cuda_device, torch.float64, mode)
    assert fwd["reprojection"] > 0 and fwd["assemble_blocks"] > 0
    if mode == "unroll":  # the linearizations replay through the Function
        assert bwd["reprojection"] == 0
    # DLM's central difference magnifies the card twins' atomic sums: its
    # reference runs on the CPU, where the sums have one order
    ref_device = torch.device("cpu") if mode == "dlm" else cuda_device
    loss_p, grad_p, fwd_p, _ = _robust_ba_grad(ref_device, torch.float64, mode, plain=True)
    assert sum(fwd_p.values()) == 0
    assert np.isfinite(grad) and grad != 0.0
    np.testing.assert_allclose(loss, loss_p, rtol=1e-9)
    np.testing.assert_allclose(grad, grad_p, rtol=1e-7)
    if mode == "implicit":
        _, grad32, _, _ = _robust_ba_grad(cuda_device, torch.float32, mode)
        assert abs(grad32 - grad_p) <= 5e-2 * abs(grad_p)


@pytest.mark.parametrize("whole", [False, True], ids=["levels", "whole"])
def test_dlm_gradient_on_card_matches_twins(cuda_device, whole):
    """DLM at PGO 64 x 16, float64: kernels against the plain twins on the
    CPU to 1e-7;
    backward() runs the two perturbed solves through the factorization and
    substitution kernels of the plan."""
    _cuda.reset_launches()
    loss, grad, _, bwd = _training_grad(cuda_device, torch.float64, "dlm", whole, n=64, b=16)
    if whole:
        assert bwd["whole_factor"] == 2 and bwd["whole_fwd_subst"] == 2 and bwd["whole_bwd_subst"] == 2
        assert bwd["level_factor"] == 0
    else:
        assert bwd["level_factor"] > 0 and bwd["level_fwd_subst"] == bwd["level_bwd_subst"] == bwd["level_factor"]
        assert bwd["whole_factor"] == 0
    assert bwd["between_se3"] > 0
    with config.plain_path():  # on the CPU: one order of the twins' sums
        loss_p, grad_p, _, _ = _training_grad(torch.device("cpu"), torch.float64, "dlm", False, n=64, b=16)
    assert np.isfinite(grad) and grad != 0.0
    np.testing.assert_allclose(loss, loss_p, rtol=1e-9)
    np.testing.assert_allclose(grad, grad_p, rtol=1e-7)


# ---------------------------------------------------------------------------
# the dense linearization, autodiff costs and kinematics (no kernel of their
# own: cholesky_ex / solve_ex and batched matmuls; the PGO's dense jacobian
# comes from the Between kernel)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("solver", ["cholesky", "lu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_solvers_on_card_match_cpu(cuda_device, solver, dtype):
    """A batch of SPD systems with one negative definite element: on the
    card cholesky_ex gives that element a partial factor and info > 0, and
    the solver must still zero and flag it (LU solves it)."""
    from theseus_tpu_torch.optim.linear import DenseCholeskySolver, DenseLUSolver

    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 40, 32))
    ata = np.einsum("bmi,bmj->bij", a, a) + 0.1 * np.eye(32)
    ata[5] = -np.eye(32)
    atb = rng.standard_normal((16, 32))
    cls = DenseCholeskySolver if solver == "cholesky" else DenseLUSolver
    out = {}
    for dev in ("cpu", cuda_device):
        delta, bad = cls().solve(torch.as_tensor(ata, dtype=dtype, device=dev),
                                 torch.as_tensor(atb, dtype=dtype, device=dev), 1e-3, True)
        out[str(dev)] = (delta.cpu(), bad.cpu())
    (dc, bc), (dg, bg) = out["cpu"], out["cuda"]
    assert torch.equal(bc, bg) and bool(bg[5]) == (solver == "cholesky") and int(bg.sum()) == bool(bg[5])
    tol = 1e-9 if dtype == torch.float64 else 2e-3
    torch.testing.assert_close(dg, dc, atol=tol * float(dc.abs().max()), rtol=0)


def _ik_layer(device, dtype, batch):
    from theseus_tpu_torch.utils.examples.inverse_kinematics import build_ik_layer, ik_targets

    layer, fk, robot = build_ik_layer(dtype, device)
    targets = ik_targets(fk, robot.dof, batch, torch.float64, device).to(dtype)
    return layer, {"theta": torch.zeros(batch, robot.dof, dtype=dtype, device=device), "target": targets}


def test_ik_on_card_matches_cpu(cuda_device):
    """The 7-dof serving IK in float64 (dense linearization, autodiff FK
    cost, 12 LM iterations from zero): the card against the CPU, 1e-9."""
    thetas = {}
    for dev in ("cpu", cuda_device):
        layer, inputs = _ik_layer(dev, torch.float64, 16)
        _cuda.reset_launches()
        out, info = layer.forward(inputs)
        thetas[str(dev)] = out["theta"].cpu()
        assert sum(_cuda.launches.values()) == 0 and torch.isfinite(info.last_err).all()
    torch.testing.assert_close(thetas["cuda"], thetas["cpu"], atol=1e-9, rtol=0)


def test_dense_pgo_on_card_matches_cpu(cuda_device):
    """PGO 24 x 4 float64 on the dense linearization: the Between kernel
    linearizes (2 launches an iteration + 1), the plateau equals the CPU's."""
    import theseus_tpu_torch as tt

    errs = {}
    for dev in ("cpu", cuda_device):
        gt, edges, meas, init = synthetic_pose_graph(24, 4, seed=3, dtype=torch.float64, device=dev)
        obj, _ = build_pgo_objective(24, edges, meas, gt[0], dtype=torch.float64, device=dev)
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True))
        _cuda.reset_launches()
        _, info = layer.forward(pose_values(init))
        errs[str(dev)] = info.last_err.cpu()
        if dev != "cpu":
            assert _cuda.launches["between_se3"] == 2 * 15 + 1 and _cuda.launches["assemble_blocks"] == 0
    torch.testing.assert_close(errs["cuda"], errs["cpu"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("problem", ["ik", "pgo"])
def test_dense_run_scan_never_syncs_with_the_host(cuda_device, problem):
    """The dense LM loop (autodiff IK, or PGO through the Between kernel)
    never waits for the card: an iteration enqueued behind a one-second
    sleep kernel returns to the host long before it ends. (torch's sync
    debug mode misses the sync of torch.cholesky_solve, which this catches:
    the solver uses two solve_triangular calls instead.)"""
    import time

    import theseus_tpu_torch as tt

    if problem == "ik":
        layer, inputs = _ik_layer(cuda_device, torch.float32, 64)
        obj, opt = layer.objective, layer.optimizer
    else:
        gt, edges, meas, init = synthetic_pose_graph(32, 8, seed=4, dtype=torch.float32, device=cuda_device)
        obj, _ = build_pgo_objective(32, edges, meas, gt[0], dtype=torch.float32, device=cuda_device)
        opt, inputs = tt.LevenbergMarquardt(obj, max_iterations=3, adaptive_damping=True), pose_values(init)
    co = obj.compile()
    values = obj.default_values(inputs)
    bsz = co.resolve_batch_size(values)
    state, aux = co.pack(values, bsz), co.build_aux(values, bsz)
    with torch.no_grad():
        carry = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, 1, opt.opts)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2.0e9))  # at least 1 s at the H100's top clock of 1.98 GHz
        t0 = time.perf_counter()
        carry = opt.run_scan(carry, aux, 1, opt.opts)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    assert host_s < 0.5, host_s
    assert torch.isfinite(carry["err"]).all()


# ---------------------------------------------------------------------------
# the 2-D pose graph: SE2 at block size 3, batch 1 (scripts/manhattan_g2o.py)
# ---------------------------------------------------------------------------
def _manhattan_graph(tmp_path, poses, device=None):
    """scripts/manhattan_g2o.py's graph written to tmp_path and read back by
    read_2d_g2o (device None: the card)."""
    import importlib.util
    from pathlib import Path

    from theseus_tpu_torch.utils.examples.pose_graph import read_2d_g2o

    spec = importlib.util.spec_from_file_location(
        "manhattan_g2o", Path(__file__).resolve().parents[1] / "scripts" / "manhattan_g2o.py")
    mg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mg)
    path = tmp_path / f"manhattan_{poses}.g2o"
    mg.write_g2o(path, mg.generate(poses, 0))
    return read_2d_g2o(path, dtype=torch.float64, device=device)


def _se2_layer(graph, dtype, device, iters=30):
    import theseus_tpu_torch as tt

    n, poses, edges, meas, w = graph
    w0 = w[0].double().cpu().numpy()
    obj = tt.Objective(dtype=dtype, device=device)
    xs = [tt.SE2(name=f"pose_{i}") for i in range(n)]
    obj.add(tt.Local(xs[0], poses[0].cpu().numpy(), tt.ScaleCostWeight(10.0), name="prior"))
    weight = tt.DiagonalCostWeight(np.sqrt(np.diag(w0.T @ w0))[None])
    meas = meas.cpu().numpy()
    for e, (i, j) in enumerate(edges):
        obj.add(tt.Between(xs[i], xs[j], meas[e], cost_weight=weight, name=f"edge_{e}"))
    opt = LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True, linearization="sparse")
    return tt.TheseusLayer(opt), {f"pose_{i}": poses[i] for i in range(n)}


def test_read_2d_g2o_and_rand_se2_land_on_the_card(cuda_device, tmp_path):
    import theseus_tpu_torch as tt

    n, poses, edges, meas, w = _manhattan_graph(tmp_path, 40)
    assert all(t.device.type == "cuda" for t in (poses, meas, w))
    assert tuple(poses.shape) == (n, 1, 4) and tuple(w.shape) == (len(edges), 3, 3)
    v = tt.rand_se2(3, generator=torch.Generator().manual_seed(0))
    assert v.tensor.device.type == "cuda" and tuple(v.tensor.shape) == (3, 4)
    assert bool(tt.lie.se2.check_group_tensor(v.tensor).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se2_kernels_match_twins_at_block_size_3(cuda_device, dtype, tmp_path):
    """The assembly and every level's three kernels against their twins at
    the shapes a 500-pose Manhattan graph gives them (d = 3, B = 1)."""
    from theseus_tpu_torch.sparse.assemble import _pad_jac
    from theseus_tpu_torch.sparse.cholesky import (
        backward_sweep, bwd_operands, factor_operands, forward_sweep, fwd_operands)

    layer, inputs = _se2_layer(_manhattan_graph(tmp_path, 500, cuda_device), dtype, cuda_device)
    co = layer.objective.compile()
    values = layer.objective.default_values(inputs)
    state, aux = co.pack(values, 1), co.build_aux(values, 1)
    bld = layer.optimizer.normal_builder
    assert bld.pattern.d == 3 and bld.sched.tail_k > 0
    with config.plain_path():
        blocks = co.linearize_blocks(state, aux)
        ata, atb = assemble(bld.pattern, blocks)
        lflat = factorize(bld.sched, ata)
        perm, _, levels = bld.sched.on(ata.device)
        y = forward_sweep(bld.sched, lflat, atb[perm])
        x = backward_sweep(bld.sched, lflat, y)
    padded = [([_pad_jac(j, 3) for j in jacs], err) for jacs, err in blocks]
    _cuda.reset_launches()
    got = assemble_blocks(bld.pattern, padded)
    for g, want in zip(got, assemble_blocks_plain(bld.pattern, padded)):
        _close(g, want, dtype, float(want.abs().max()))
    for t in levels:
        fact, fwd, bwd = factor_operands(t, ata, lflat), fwd_operands(t, lflat, y, atb[perm]), bwd_operands(t, lflat, x, y)
        want = level_factor_plain(*fact)
        _close(level_factor(*fact), want, dtype, float(want.abs().max()))
        want = level_fwd_subst_plain(*fwd)
        _close(level_fwd_subst(*fwd), want, dtype, float(want.abs().max()))
        want = level_bwd_subst_plain(*bwd)
        _close(level_bwd_subst(*bwd), want, dtype, float(want.abs().max()))
    assert _cuda.launches["assemble_blocks"] == 1
    assert _cuda.launches["level_factor"] == _cuda.launches["level_bwd_subst"] == len(levels)


def test_se2_sparse_solve_runs_the_kernels(cuda_device, tmp_path):
    """An 800-pose Manhattan graph through TheseusLayer.forward: the
    counters show the assembly once an iteration and the level kernels once
    a head level an iteration, no twin runs, and the float32 plateau and the
    float64 one sit where the float64 twins' does (2e-3, 1e-8)."""
    from unittest import mock

    from theseus_tpu_torch.sparse import assemble_kernel, level_kernels

    graph = _manhattan_graph(tmp_path, 800, cuda_device)
    results = {}
    for dtype in (torch.float32, torch.float64):
        layer, inputs = _se2_layer(graph, dtype, cuda_device)
        n_levels = len(layer.optimizer.normal_builder.sched.level_tables)
        twins = [mock.patch.object(level_kernels, f"{k}_plain", wraps=getattr(level_kernels, f"{k}_plain"))
                 for k in ("level_factor", "level_fwd_subst", "level_bwd_subst")]
        twins.append(mock.patch.object(assemble_kernel, "assemble_blocks_plain",
                                       wraps=assemble_kernel.assemble_blocks_plain))
        _cuda.reset_launches()
        with contextlib.ExitStack() as stack:
            spies = [stack.enter_context(t) for t in twins]
            _, info = layer.forward(inputs)
            torch.cuda.synchronize()
        assert [s.call_count for s in spies] == [0, 0, 0, 0]
        assert _cuda.launches["assemble_blocks"] == 30 and _cuda.launches["between_se3"] == 0
        for k in ("level_factor", "level_fwd_subst", "level_bwd_subst"):
            assert _cuda.launches[k] == 30 * n_levels, k
        results[dtype] = info.last_err
    layer, inputs = _se2_layer(graph, torch.float64, cuda_device)
    with config.plain_path():
        _, ref = layer.forward(inputs)
    rel = lambda a: float(((a.double() - ref.last_err).abs() / ref.last_err).max())  # noqa: E731
    assert rel(results[torch.float32]) <= 2e-3
    assert rel(results[torch.float64]) <= 1e-8


# ---------------------------------------------------------------------------
# GPMP2 motion planning: Point2 / Vector(2) variables, block size 2
# ---------------------------------------------------------------------------
def _planner_inputs(planner, b, dtype, device, map_size=128, cell=0.1, seed=0):
    from theseus_tpu_torch.utils.examples.motion_planning import synthetic_maps

    sdf, start, goal = synthetic_maps(b, map_size, cell, seed=seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    inputs = dict(planner.straight_line_initialization(t(start), t(goal)))
    inputs.update(start=t(start), goal=t(goal), sdf_origin=torch.zeros((b, 2), dtype=dtype, device=device),
                  sdf_data=t(sdf), cell_size=torch.full((b, 1), cell, dtype=dtype, device=device))
    return inputs


def _planner(dtype, device, steps=100, iters=50, **kw):
    from theseus_tpu_torch.utils.examples.motion_planning import MotionPlanner

    if kw.get("optimizer_cls") is None:
        kw["adaptive_damping"] = True
    return MotionPlanner(128, 0.8, 10.0, 20.0, np.eye(2), steps, max_iterations=iters, dtype=dtype, device=device,
                         linearization="sparse", **kw)


def _as_accurate_as_twin(kernel, twin, inputs, dtype):
    """float64: within the file's tolerance of the twin. float32: the
    planner's block matrix is ill-conditioned (cond ~1e7) and the factor's
    2x2 pivots cancel, so two correct float32 implementations that round in
    another order differ by more than that (2.9e-5 of the largest entry on
    an H100); the kernel's error against the twin evaluated in float64 on
    the same inputs is held to at most twice the float32 twin's, plus
    2e-5, relative to max(1, |twin|)."""
    got, want = kernel(*inputs), twin(*inputs)
    got, want = (got,) if isinstance(got, torch.Tensor) else got, (want,) if isinstance(want, torch.Tensor) else want
    scale = max([1.0] + [float(w.abs().max()) for w in want])
    if dtype == torch.float64:
        for g, w in zip(got, want):
            _close(g, w, dtype, scale)
        return
    ref = twin(*[t.double() for t in inputs])
    ref = (ref,) if isinstance(ref, torch.Tensor) else ref
    ek = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    et = max(float((w.double() - r).abs().max()) for w, r in zip(want, ref))
    assert ek <= 2 * et + 2e-5 * scale, (ek, et, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 8])
def test_planner_kernels_match_twins_at_block_size_2(cuda_device, dtype, batch):
    """The assembly and every level's three kernels against their twins at
    the shapes the planner at its full size (128 x 128, 100 steps) gives
    them (d = 2), and sample_with_factor's backward sweep on the same y
    (_as_accurate_as_twin)."""
    from theseus_tpu_torch.sparse.assemble import _pad_jac
    from theseus_tpu_torch.sparse.cholesky import (
        backward_sweep, bwd_operands, factor_operands, forward_sweep, fwd_operands, sample_with_factor)

    planner = _planner(dtype, cuda_device)
    co = planner.objective.compile()
    values = planner.objective.default_values(_planner_inputs(planner, batch, dtype, cuda_device))
    state, aux = co.pack(values, batch), co.build_aux(values, batch)
    bld = planner.optimizer.normal_builder
    assert bld.pattern.d == 2 and bld.sched.tail_k == 0
    with config.plain_path():
        blocks = co.linearize_blocks(state, aux)
        ata, atb = assemble(bld.pattern, blocks)
        ata = ata.clone()
        ata[1:bld.pattern.n_vars + 1] += 1e-3 * torch.eye(2, dtype=dtype, device=cuda_device)
        lflat = factorize(bld.sched, ata)
        perm, _, levels = bld.sched.on(ata.device)
        y = forward_sweep(bld.sched, lflat, atb[perm])
        x = backward_sweep(bld.sched, lflat, y)
    ys = torch.randn((bld.pattern.n_vars, batch, 2), dtype=dtype, device=cuda_device)

    def plain(fn):
        def run(*args):
            with config.plain_path():
                return fn(*args)
        return run

    padded = [([_pad_jac(j, 2) for j in jacs], err) for jacs, err in blocks]
    _cuda.reset_launches()
    for g, want in zip(assemble_blocks(bld.pattern, padded), assemble_blocks_plain(bld.pattern, padded)):
        _close(g, want, dtype, float(want.abs().max()))
    for t in levels:
        for k, pl, ops in ((level_factor, level_factor_plain, factor_operands(t, ata, lflat)),
                           (level_fwd_subst, level_fwd_subst_plain, fwd_operands(t, lflat, y, atb[perm])),
                           (level_bwd_subst, level_bwd_subst_plain, bwd_operands(t, lflat, x, y))):
            _as_accurate_as_twin(k, pl, ops, dtype)
    assert _cuda.launches["assemble_blocks"] == 1
    assert _cuda.launches["level_factor"] == _cuda.launches["level_bwd_subst"] == len(levels)
    _as_accurate_as_twin(lambda l_, y_: sample_with_factor(bld.sched, l_, y_),
                         plain(lambda l_, y_: sample_with_factor(bld.sched, l_, y_)), (lflat, ys), dtype)
    assert _cuda.launches["level_bwd_subst"] == 2 * len(levels)


@pytest.mark.parametrize("optimizer", ["LevenbergMarquardt", "Dogleg"])
def test_small_planner_on_card_matches_cpu(cuda_device, optimizer):
    """A 128 x 128, 20-step planner at batch 2 in float64 on the sparse
    plan: the card (kernels) against the CPU (twins), 1e-8 on the final
    errors and trajectories; compute_samples and compute_covariances run
    on the card."""
    import theseus_tpu_torch as tt

    kw = {} if optimizer == "LevenbergMarquardt" else {"optimizer_cls": tt.Dogleg}
    results = {}
    for device in (cuda_device, torch.device("cpu")):
        planner = _planner(torch.float64, device, steps=20, iters=30, **kw)
        _cuda.reset_launches()
        values, info = planner.layer.forward(_planner_inputs(planner, 2, torch.float64, device))
        torch.cuda.synchronize()
        if device.type == "cuda":
            n_levels = len(planner.optimizer.normal_builder.sched.level_tables)
            assert _cuda.launches["assemble_blocks"] == 30 and _cuda.launches["level_factor"] == 30 * n_levels
            covs = planner.layer.compute_covariances(values=values, var_names=["pose_10"])
            samples = planner.layer.compute_samples(values=values, n_samples=4, generator=torch.Generator().manual_seed(0))
            assert covs["pose_10"].device.type == "cuda" and bool(torch.isfinite(covs["pose_10"]).all())
            assert tuple(samples["pose_10"].shape) == (2, 4, 2) and bool(torch.isfinite(samples["pose_10"]).all())
        results[device.type] = (info.last_err.cpu(), planner.trajectory(values).cpu())
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-8, atol=0.0)
    torch.testing.assert_close(results["cuda"][1], results["cpu"][1], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("mode", ["unroll", "implicit", "dlm"])
def test_tactile_trainer_on_card_matches_cpu(cuda_device, mode):
    """The tactile trainer (T = 12, windows 1..3, batch 4, float64, sparse
    plan) in three backward modes: the loss and every parameter's gradient,
    the card (the assembly and level kernels, counted) against the CPU
    (twins): 1e-9 and 1e-7 relative."""
    import functools

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.models import tactile

    results = {}
    for device in (cuda_device, torch.device("cpu")):
        est = tactile.TactilePoseEstimator(12, device=device, optimizer_cls=functools.partial(
            tt.LevenbergMarquardt, linearization="sparse"))
        base, obj_gt, _, feats = tactile.synthetic_push(est, batch=4, seed=0)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
        tr = tactile.TactileTrainer(est, 8, generator=torch.Generator().manual_seed(0), backward_mode=mode,
                                    dtype=torch.float64, device=device)
        _cuda.reset_launches()
        loss = tr.loss({k: t(v) for k, v in base.items()}, {i: t(v) for i, v in feats.items()}, t(obj_gt))
        grads = torch.autograd.grad(loss, tr.parameters())
        torch.cuda.synchronize()
        if device.type == "cuda":
            n_levels = len(est.optimizer.normal_builder.sched.level_tables)
            assert _cuda.launches["assemble_blocks"] >= 1
            assert _cuda.launches["level_factor"] >= n_levels * _cuda.launches["assemble_blocks"]
        results[device.type] = (loss.detach().cpu(), torch.cat([g.reshape(-1) for g in grads]).cpu())
    torch.testing.assert_close(results["cuda"][0], results["cpu"][0], rtol=1e-9, atol=0.0)
    g, ref = results["cuda"][1], results["cpu"][1]
    assert float((g - ref).norm() / ref.norm()) <= 1e-7


def test_pcg_on_card_matches_cpu(cuda_device):
    """PGO 24 x 4 in float64 on sparse_solver="pcg": the LM solution on the
    card (the Between and assembly kernels, no level kernel) against the
    CPU, 1e-9."""
    from theseus_tpu_torch.layer import TheseusLayer

    sols = {}
    for device in (cuda_device, torch.device("cpu")):
        gt, edges, meas, init = synthetic_pose_graph(24, 4, seed=0, dtype=torch.float64, device=device)
        obj, _ = build_pgo_objective(24, edges, meas, gt[0], dtype=torch.float64, device=device)
        layer = TheseusLayer(LevenbergMarquardt(obj, max_iterations=10, linearization="sparse",
                                                sparse_solver="pcg", pcg_iters=100))
        _cuda.reset_launches()
        out, _ = layer.forward(pose_values(init))
        torch.cuda.synchronize()
        if device.type == "cuda":
            assert _cuda.launches["assemble_blocks"] == 10 and _cuda.launches["between_se3"] > 0
            assert _cuda.launches["level_factor"] == 0 and _cuda.launches["whole_factor"] == 0
        sols[device.type] = torch.stack([out[f"pose_{i}"] for i in range(24)]).cpu()
    torch.testing.assert_close(sols["cuda"], sols["cpu"], rtol=1e-9, atol=1e-9)


def test_dcem_on_card_matches_cpu(cuda_device):
    """DCEM on the 7-dof IK (batch 8, 10 iterations, float64), the same
    noise from a CPU generator: the card against the CPU, 1e-9."""
    import theseus_tpu_torch as tt

    thetas = {}
    for device in (cuda_device, torch.device("cpu")):
        layer, inputs = _ik_layer(device, torch.float64, 8)
        opt = tt.DCEM(layer.objective, max_iterations=10, generator=torch.Generator().manual_seed(0))
        out, info = opt.optimize(input_tensors=inputs)
        thetas[device.type] = out["theta"].cpu()
    torch.testing.assert_close(thetas["cuda"], thetas["cpu"], rtol=1e-9, atol=1e-9)


def test_gbp_on_card_matches_cpu(cuda_device):
    """Gaussian belief propagation on PGO 16 x 4 in float64 (the Between
    kernel on the card): the solution and compute_covariances against the
    CPU, 1e-10 and 1e-8."""
    import theseus_tpu_torch as tt

    res = {}
    for device in (cuda_device, torch.device("cpu")):
        gt, edges, meas, init = synthetic_pose_graph(16, 4, seed=0, dtype=torch.float64, device=device)
        obj, _ = build_pgo_objective(16, edges, meas, gt[0], dtype=torch.float64, device=device)
        layer = tt.TheseusLayer(tt.GaussianBeliefPropagation(obj, max_iterations=8, msg_iters=20, msg_damping=0.3))
        _cuda.reset_launches()
        out, _ = layer.forward(pose_values(init))
        torch.cuda.synchronize()
        if device.type == "cuda":
            assert _cuda.launches["between_se3"] > 0 and _cuda.launches["assemble_blocks"] == 0
        cov = layer.compute_covariances(values=out, var_names=["pose_5"])["pose_5"]
        res[device.type] = (torch.stack([out[f"pose_{i}"] for i in range(16)]).cpu(), cov.cpu())
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(res["cuda"][1], res["cpu"][1], rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# the utilities, the native symbolic analysis and the homography task
# (no kernel of the table on these paths; the unvectorized PGO solve runs
# the Between and assembly kernels at K = 1)
# ---------------------------------------------------------------------------
def test_warp_and_easyaug_on_card_match_cpu(cuda_device):
    from theseus_tpu_torch.utils.examples import easyaug
    from theseus_tpu_torch.utils.warp import bilinear_sample, homography_transform, image_grid

    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(size=(20, 26, 3)))
    h8 = torch.tensor([1.02, 0.01, 1.5, -0.02, 0.98, -1.0, 1e-4, -5e-5], dtype=torch.float64)
    xy = homography_transform(h8, image_grid(20, 26, dtype=torch.float64))
    want = bilinear_sample(img, xy)
    got = bilinear_sample(img.to(cuda_device), homography_transform(h8.to(cuda_device), image_grid(
        20, 26, dtype=torch.float64, device=cuda_device)))
    torch.testing.assert_close(got.cpu(), want, atol=1e-12, rtol=1e-12)

    imgs = torch.as_tensor(rng.uniform(size=(4, 2, 20, 26)))
    photo = easyaug.RandomPhotoAug()
    photo.set_all_probs(0.7)
    draws = photo.draw(4, 20, 26, torch.Generator().manual_seed(0), torch.float64)
    on_card = {op: {k: v.to(cuda_device) for k, v in d.items()} for op, d in draws.items()}
    torch.testing.assert_close(photo.apply(imgs.to(cuda_device), on_card).cpu(), photo.apply(imgs, draws),
                               atol=1e-12, rtol=1e-12)
    geo = easyaug.RandomGeoAug()
    gd = geo.draw(4, torch.Generator().manual_seed(1), torch.float64)
    out, mats = geo.forward(imgs.to(cuda_device), return_transform=True,
                            draws={k: v.to(cuda_device) for k, v in gd.items()})
    want_out, want_mats = geo.forward(imgs, return_transform=True, draws=gd)
    torch.testing.assert_close(mats.cpu(), want_mats, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(out.cpu(), want_out, atol=1e-10, rtol=1e-10)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    aug = photo.forward(geo.forward(imgs.to(cuda_device), gen), gen)
    assert aug.device.type == "cuda" and bool(torch.isfinite(aug).all())


def test_learned_homography_step_on_card_matches_cpu(cuda_device):
    from theseus_tpu_torch.utils.examples import homography as hg

    def trainer(dev):
        return hg.HomographyTrainer(48, 64, 4, 8, "fwd", 4, dtype=torch.float64, device=dev,
                                    generator=torch.Generator().manual_seed(0) if dev == "cpu" else None)

    cpu = trainer("cpu")
    card = trainer(cuda_device)
    card.cnn.load_state_dict(cpu.cnn.state_dict())
    pairs = hg.make_pairs(4, 48, 64, generator=torch.Generator().manual_seed(1), dtype=torch.float64, device="cpu")
    want = cpu.step(*pairs)
    got = card.step(*(p.to(cuda_device) for p in pairs))
    torch.testing.assert_close(got.cpu(), want, atol=1e-9, rtol=1e-9)
    for (name, a), (_, b) in zip(card.cnn.named_parameters(), cpu.cnn.named_parameters()):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-8, rtol=1e-8, msg=name)
    f32 = hg.HomographyTrainer(48, 64, 4, 4, "rev", 4, device=cuda_device)
    loss = f32.step(*(p.float().to(cuda_device) for p in pairs))
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(p.grad).all()) for p in f32.cnn.parameters())


def test_unvectorized_pgo_solve_runs_kernels_at_k1(cuda_device):
    gt, edges, meas, init = synthetic_pose_graph(16, 4, seed=0, dtype=torch.float64, device=cuda_device)

    def solve(vectorize):
        obj, _ = build_pgo_objective(16, edges, meas, gt[0], dtype=torch.float64, device=cuda_device)
        from theseus_tpu_torch.layer import TheseusLayer

        layer = TheseusLayer(LevenbergMarquardt(obj, max_iterations=8, adaptive_damping=True,
                                                linearization="sparse"), vectorize=vectorize)
        _cuda.reset_launches()
        with pytest.warns(UserWarning) if not vectorize else contextlib.nullcontext():
            out, info = layer.forward(pose_values(init))
        torch.cuda.synchronize()
        assert all(bk.k == 1 for bk in obj.compile().buckets) or vectorize
        return torch.stack([out[f"pose_{i}"] for i in range(16)]), info.last_err, dict(_cuda.launches)

    vec, vec_err, _ = solve(True)
    off, off_err, launches = solve(False)
    assert launches["between_se3"] > 0 and launches["assemble_blocks"] > 0
    torch.testing.assert_close(off, vec, atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(off_err, vec_err, atol=1e-10, rtol=1e-10)


def test_native_build_in_fresh_directory(cuda_device, tmp_path, monkeypatch):
    import theseus_tpu_torch.native as native
    from theseus_tpu_torch.sparse.structure import symbolic_factor

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_root", lambda: tmp_path / "_build")
    path = native.build()
    assert path.exists() and native.build_seconds > 0
    pairs = {(i, i + 1) for i in range(39)} | {(0, 20), (5, 30)}
    for ordering in ("amd", "nd", "natural"):
        a = symbolic_factor(40, pairs, 3, ordering)
        b = symbolic_factor(40, pairs, 3, ordering, native=False)
        assert a.perm.tolist() == b.perm.tolist() and a.block_of == b.block_of and a.upd_lists == b.upd_lists


def test_two_shard_solve_on_card(cuda_device):
    """PGO 16 x 8 in float64 on the level plan, batch-sharded over
    make_mesh(devices=[cuda:0, cuda:0]) (two shards of 4, each under
    torch.cuda.device): the joined solution against the unsharded solve on
    the card (1e-10), every kernel of the path launched by each shard as
    often as by the unsharded solve of the same shard size, and the
    implicit gradient with respect to the loop-closure weight (1e-9)."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.parallel import make_mesh, shard_map_solve, shard_problem
    from theseus_tpu_torch.utils.examples.pose_graph import training_weights

    dev = torch.device("cuda", 0)
    gt, edges, meas, init = synthetic_pose_graph(16, 8, seed=0, dtype=torch.float64, device=dev)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(16, edges, meas, gt[0], dtype=torch.float64, device=dev, edge_weight=w_odo,
                                 loop_weight=w_loop)
    layer = tt.TheseusLayer(LevenbergMarquardt(obj, max_iterations=8, adaptive_damping=True, linearization="sparse"))
    co = obj.compile()

    def solve(sharded):
        theta = torch.tensor(1.3, dtype=torch.float64, device=dev, requires_grad=True)
        values = obj.default_values(dict(pose_values(init), w_loop=theta.reshape(1, 1)))
        state, aux = co.pack(values, 8), co.build_aux(values, 8)
        mesh = make_mesh(devices=[dev, dev])
        _cuda.reset_launches()
        if sharded:
            carry = shard_map_solve(layer, mesh, "implicit")(*shard_problem(co, state, aux, mesh))
        else:
            carry = layer.solve_state(state, aux, "implicit", layer.optimizer.opts)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        (g,) = torch.autograd.grad(carry["state"]["SE3"].square().sum(), [theta])
        return carry, launches, g

    ref, ref_launches, ref_g = solve(False)
    out, launches, g = solve(True)
    torch.testing.assert_close(out["state"]["SE3"], ref["state"]["SE3"], rtol=0, atol=1e-10)
    torch.testing.assert_close(g, ref_g, rtol=1e-9, atol=1e-12)
    assert out["it"] == ref["it"] and out["state"]["SE3"].device == dev
    for k in ("between_se3", "assemble_blocks", "level_factor", "level_fwd_subst", "level_bwd_subst"):
        assert launches[k] > 0, k
    # assembly and factorization once a solve: each shard repeats the unsharded schedule
    assert launches["assemble_blocks"] >= ref_launches["assemble_blocks"]


def test_make_mesh_raises_past_the_cards(cuda_device):
    from theseus_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    assert len(make_mesh()) == n and make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match=f"needs {n + 1} CUDA devices but {n} are present"):
        make_mesh(n + 1)


def test_gbp_factor_sharded_on_card(cuda_device):
    """GBP on PGO 32 x 2 in float64, the 32 Between factors (the chain and
    one closure) split over [cuda:0, cuda:0]: the sharded delta against the
    unsharded delta on the card (1e-10), with cross-device belief sums
    counted, and against the CPU's (1e-9)."""
    from theseus_tpu_torch.lie import se3 as tse3
    from theseus_tpu_torch.optim.gbp import GBPNormalBuilder
    from theseus_tpu_torch.parallel import make_mesh, shard_gbp_factors

    deltas = {}
    for device in (cuda_device, torch.device("cpu")):
        gt, edges, meas, init = synthetic_pose_graph(32, 2, seed=0, dtype=torch.float64, device=device,
                                                     extra_loop_closures=False)
        closure = tse3.compose(tse3.inverse(gt[0]), gt[16])
        obj, _ = build_pgo_objective(32, edges + [(0, 16)], torch.cat([meas, closure[None]]), gt[0],
                                     dtype=torch.float64, device=device)
        co = obj.compile()
        values = obj.default_values(pose_values(init))
        normal = GBPNormalBuilder(co, msg_iters=15, msg_damping=0.3).build(co.pack(values, 2), co.build_aux(values, 2))
        sharded = shard_gbp_factors(normal, make_mesh(devices=[device, device], axis="factors"))
        delta, _ = sharded.solve(1e-3)
        assert sharded.cross_device_sums > 0 and delta.device.type == device.type
        want, _ = normal.solve(1e-3)
        torch.testing.assert_close(delta, want, rtol=0, atol=1e-10)
        deltas[device.type] = delta.cpu()
    torch.testing.assert_close(deltas["cuda"], deltas["cpu"], rtol=0, atol=1e-9)


def test_shard_per_card_solve(cuda_device):
    """With two or more cards: PGO 16 x 8 in float64 sharded one shard per
    card (each launched under its own current device), the solution joined
    on cuda:0 against the unsharded solve (1e-10), and the implicit
    gradient through the join (1e-9). Skips on one card."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.parallel import make_mesh, shard_map_solve, shard_problem
    from theseus_tpu_torch.utils.examples.pose_graph import training_weights

    n_cards = torch.cuda.device_count()
    if n_cards < 2 or 8 % n_cards:
        pytest.skip("needs 2, 4 or 8 GPUs")
    dev = torch.device("cuda", 0)
    gt, edges, meas, init = synthetic_pose_graph(16, 8, seed=0, dtype=torch.float64, device=dev)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(16, edges, meas, gt[0], dtype=torch.float64, device=dev, edge_weight=w_odo,
                                 loop_weight=w_loop)
    layer = tt.TheseusLayer(LevenbergMarquardt(obj, max_iterations=8, adaptive_damping=True, linearization="sparse"))
    co = obj.compile()
    out = {}
    for sharded in (False, True):
        theta = torch.tensor(1.3, dtype=torch.float64, device=dev, requires_grad=True)
        values = obj.default_values(dict(pose_values(init), w_loop=theta.reshape(1, 1)))
        state, aux = co.pack(values, 8), co.build_aux(values, 8)
        if sharded:
            mesh = make_mesh()
            states, auxes = shard_problem(co, state, aux, mesh)
            assert [s["SE3"].device for s in states] == list(mesh.devices)
            carry = shard_map_solve(layer, mesh, "implicit")(states, auxes)
        else:
            carry = layer.solve_state(state, aux, "implicit", layer.optimizer.opts)
        (g,) = torch.autograd.grad(carry["state"]["SE3"].square().sum(), [theta])
        out[sharded] = (carry["state"]["SE3"].detach(), g)
    assert out[True][0].device == dev
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=1e-10)
    torch.testing.assert_close(out[True][1], out[False][1], rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# evaluations_torch: each script's main() on the card at chip_smoke's size,
# its results file written into a temporary directory
# ---------------------------------------------------------------------------
def _eval_main(name, argv, tmp_path, monkeypatch, **kwargs):
    import importlib

    mod = importlib.import_module(f"evaluations_torch.{name}")
    monkeypatch.setattr(mod, "OUT", tmp_path / mod.OUT.name)
    _cuda.reset_launches()
    out = mod.main(argv, **kwargs)
    torch.cuda.synchronize()
    assert "Card: " in next(tmp_path.glob("*.md")).read_text()
    return mod, out, dict(_cuda.launches)


def test_eval_vectorization_on_card(cuda_device, tmp_path, monkeypatch):
    """16 and 64 poses x 16, all three arms (the window cut to (2, 8)
    iterations): the kernel arm launches rows 1-4b; every arm's float32
    final error, the batch mean, within 1e-4 of the others' and each batch
    element within the float32 PGO gate 2e-3 (float32 LM stops where its
    error stops resolving: 1.05e-3 apart per element on the CPU twins
    alone, scripts/torch_vectorize_arms.py); in float64 the vectorize False and True arms per element within
    1e-10 at 16 poses."""
    import evaluations_torch.vectorization_ablation as vec

    monkeypatch.setattr(vec, "WINDOW", (2, 8))
    _, rows, launches = _eval_main("vectorization_ablation", ["--sizes", "16,64"], tmp_path, monkeypatch)
    for k in ("between_se3", "assemble_blocks", "level_factor", "level_fwd_subst", "level_bwd_subst"):
        assert launches[k] > 0, k
    for n in (16, 64):
        errs = [r["err"].double() for r in rows if r["poses"] == n]
        assert len(errs) == 3 and all(r["ms"] > 0 for r in rows)
        for e in errs[1:]:
            assert abs(float(e.mean() - errs[0].mean())) <= 1e-4 * float(errs[0].mean())
            torch.testing.assert_close(e, errs[0], rtol=2e-3, atol=0)
    f64 = []
    for v, kernels in ((False, False), (True, True)):
        with contextlib.nullcontext() if kernels else config.plain_path():
            layer, state, aux = vec.build(16, 16, v, torch.float64, cuda_device)
            f64.append(vec.lm_solver(layer, state, aux)(vec.FIRST_ITERS))
    torch.testing.assert_close(f64[1], f64[0], rtol=1e-10, atol=0)


def test_eval_backward_modes_sweep_on_card(cuda_device, tmp_path, monkeypatch):
    """PGO 16 x 4: every float64 mode gradient against the same mode on the
    plain twins on the card (1e-7 relative), unroll against the central
    difference (1e-5), and a float32 row for every mode."""
    mod, res, launches = _eval_main("backward_modes_sweep", [], tmp_path, monkeypatch)
    assert launches["between_se3"] > 0
    assert len(res[torch.float32]["rows"]) == len(mod.MODES)
    f64 = res[torch.float64]
    with config.plain_path():
        parts = mod.build(16, 4, 10, torch.float64, cuda_device)
        for (mode, k), (label, g, rel, ms, _) in zip(mod.MODES, f64["rows"]):
            want = float(mod.gradient(mod.make_outer_loss(*parts, mode, k or 4), mod.THETA, torch.float64,
                                      cuda_device))
            assert abs(g - want) <= 1e-7 * abs(want), (label, g, want)
    assert f64["rows"][0][2] < 1e-5  # unroll against FD


def test_eval_backward_modes_tactile_on_card(cuda_device, tmp_path, monkeypatch):
    """10 steps, 3 inner iterations, float64: unroll and truncated (which
    at 3 iterations differentiate every iteration) against the central
    difference (1e-5); the level kernels ran."""
    _, rows, launches = _eval_main("backward_modes_tactile", ["--inner-iters", "3"], tmp_path, monkeypatch)
    for k in ("assemble_blocks", "level_factor", "level_fwd_subst", "level_bwd_subst"):
        assert launches[k] > 0, k
    by_mode = {r["mode"]: r for r in rows}
    for m in ("unroll", "truncated-5", "truncated-10"):
        assert by_mode[m]["rel_err"] < 1e-5, by_mode[m]
    assert all(np.isfinite(r["loss10"]) for r in rows)


def test_eval_autodiff_ablation_on_card(cuda_device, tmp_path, monkeypatch):
    """The script's table; then in float64 the analytic reprojection
    jacobians (its kernel) against fwd and rev (1e-10)."""
    mod, rows, launches = _eval_main("autodiff_ablation", [], tmp_path, monkeypatch)
    assert len(rows) == 5 and launches["reprojection"] > 0
    got = {}
    for mode in ("analytic", "fwd", "rev"):
        obj, vals = mod.reprojection_objective(mode, n=8, device=cuda_device, dtype=torch.float64)
        got[mode] = mod.linearizer(obj, vals)()
    for mode in ("fwd", "rev"):
        for (ja, ea), (jb, eb) in zip(got["analytic"], got[mode]):
            torch.testing.assert_close(ea, eb, rtol=0, atol=1e-10)
            for a, b in zip(ja, jb):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def test_eval_local_cost_on_card(cuda_device, tmp_path, monkeypatch):
    """Batches 1 and 256; the float64 3-iteration solve and its input
    gradient on the card against the CPU's (1e-10)."""
    mod, rows, _ = _eval_main("time_local_cost_backward", ["--batches", "1", "256"], tmp_path, monkeypatch)
    assert len(rows) == 4 and all(f > 0 and b > 0 for _, _, f, b in rows)
    for group in ("SO3", "SE3"):
        out = {}
        for device in (cuda_device, torch.device("cpu")):
            layer, _, state, aux, _ = mod.build(group, 8, torch.float64, device)
            nxt, loss = mod.stepper(layer, state, aux, group, backward=True)(state[group], 0.0)
            out[device.type] = (nxt.cpu(), loss.cpu())
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-10)
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-10, atol=0)


def test_eval_gbp_on_card(cuda_device, tmp_path, monkeypatch):
    """gbp_eval on its 16-pose graph (float64): the step-quality numbers
    against the CPU's (1e-8); gbp_hw_bench at 64 x 16 launches the Between
    kernel and times positive."""
    mod, res, _ = _eval_main("gbp_eval", [], tmp_path, monkeypatch, sizes=(16,))
    for n, damping, rels in res["step"]:
        want = mod.step_quality(mod.build(n, device="cpu"), damping)
        np.testing.assert_allclose(rels, want, rtol=1e-8)
    eg, en = res["outer"][0][1:]
    assert eg < 1e-10 and en < 1e-10
    _, rows, launches = _eval_main("gbp_hw_bench", [], tmp_path, monkeypatch, shapes=((64, 16),))
    assert launches["between_se3"] > 0 and all(v > 0 for v in rows[0][2:])
