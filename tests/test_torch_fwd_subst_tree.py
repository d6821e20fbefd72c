"""The level forward substitution kernel's launch geometry and summation order, on the CPU.

`csrc/level_subst.cu`'s forward kernel gives a block to each (column, tile
of bt batch elements) and gu lanes to each output (batch element, row i):
lane g sums L[u][i, :] y[u] over u = g, g + gu, ... (j inner), the update
list staged uc updates at a time, and the gu partials are added by
__shfl_down_sync in a fixed tree; then y = L_jj^{-1} (b - sum) with the
first design's statements. The kernel runs only on the card
(tests/test_torch_cuda.py); here:

- the geometry `fwd_subst_geometry` at the PGO main-path shapes and its
  invariants over a grid of shapes;
- a numpy model of that order matches the plain twin
  `level_fwd_subst_plain` to 1e-12 in float64 at ragged shapes, the
  operands laid out behind the zero slot and read in place (`fwd_stage`).
"""

import numpy as np
import pytest
import torch

from theseus_tpu_torch.sparse.level_kernels import (
    FWD_SMEM_MAX,
    FWD_THREADS_MAX,
    fwd_stage,
    fwd_subst_geometry,
    level_fwd_subst_plain,
)


# The H100's 132 SMs, two blocks each: the launch's floor of blocks there.
H100_MIN_BLOCKS = 264


# (C, ul, B, d, itemsize) -> (bt, gu, uc): the PGO 256 x 128 levels (wide
# (32, 1), level 7 (16, 8), deepest (1, 17)) and 2048 x 8 (wide (256, 1),
# deepest (1, 23)) in float32 and float64, on the H100
@pytest.mark.parametrize("shape,want", [
    ((32, 1, 128, 6, 4), (8, 1, 1)),
    ((16, 8, 128, 6, 4), (4, 8, 8)),
    ((1, 17, 128, 6, 4), (1, 32, 17)),
    ((1, 17, 128, 6, 8), (1, 32, 17)),
    ((256, 1, 8, 6, 4), (4, 1, 1)),
    ((1, 23, 8, 6, 8), (1, 32, 23)),
    ((5, 3, 7, 3, 8), (1, 4, 3)),
])
def test_geometry_at_main_path_shapes(shape, want):
    assert fwd_subst_geometry(*shape, H100_MIN_BLOCKS) == want


@pytest.mark.parametrize("min_blocks,want", [(1, (32, 1, 1)), (200, (16, 1, 1)), (264, (8, 1, 1)),
                                             (100_000, (1, 1, 1))])
def test_geometry_follows_the_cards_sms(min_blocks, want):
    """The widest PGO 256 x 128 level (32 columns, batch 128, float32): the
    tile halves until the launch has min_blocks blocks."""
    assert fwd_subst_geometry(32, 1, 128, 6, 4, min_blocks) == want


def _smem(bt, uc, d, itemsize):
    return (uc + 1) * bt * (d * d + d) * itemsize


@pytest.mark.parametrize("d,itemsize", [(3, 4), (6, 4), (6, 8), (8, 8)])
def test_geometry_invariants(d, itemsize):
    for C in (1, 2, 16, 32, 256, 4096):
        for ul in (0, 1, 2, 5, 17, 33, 64, 2000):
            for B in (1, 7, 8, 128, 1000):
                bt, gu, uc = fwd_subst_geometry(C, ul, B, d, itemsize, H100_MIN_BLOCKS)
                assert 1 <= bt <= B and gu & (gu - 1) == 0 and 1 <= gu <= 32
                assert gu >= min(ul, 32) and (gu == 1 or gu < 2 * ul)
                assert bt * d * gu <= FWD_THREADS_MAX
                assert _smem(bt, uc, d, itemsize) <= FWD_SMEM_MAX
                # one chunk, or chunks of a multiple of gu (each lane's order holds)
                assert uc == max(ul, 1) or (uc % gu == 0 and uc < ul)
                # bt only shrinks below the tile cap for a reason
                if bt < min(B, 32):
                    nb = C * -(-B // (2 * bt))
                    assert (2 * bt * d * gu > FWD_THREADS_MAX or nb < H100_MIN_BLOCKS
                            or _smem(2 * bt, min(max(ul, 1), gu), d, itemsize) > FWD_SMEM_MAX)


def model(ljk, yk, b, ldiag, bt, gu, uc):
    """The kernel's order in numpy (vectorised over columns, batch and rows;
    the tile bt changes no arithmetic)."""
    C, ul, B, d, _ = ljk.shape
    lanes = np.zeros((gu, C, B, d))
    for g in range(gu):
        for u0 in range(0, ul, uc):
            nu = min(uc, ul - u0)
            for uu in range(g, nu, gu):
                for j in range(d):
                    lanes[g] = lanes[g] + ljk[:, u0 + uu, :, :, j] * yk[:, u0 + uu, :, None, j]
    # __shfl_down_sync tree: lane k += lane k + off for k < off
    off = gu // 2
    while off:
        lanes[:off] = lanes[:off] + lanes[off: 2 * off]
        off //= 2
    acc = b - lanes[0]
    out = np.zeros_like(acc)
    for r in range(d):
        s = acc[..., r]
        for k in range(r):
            s = s - ldiag[..., r, k] * out[..., k]
        out[..., r] = s / ldiag[..., r, r]
    return out


def _inputs(rng, C, ul, B, d):
    ljk = rng.standard_normal((C, ul, B, d, d))
    yk = rng.standard_normal((C, ul, B, d))
    b = rng.standard_normal((C, B, d))
    ldiag = np.tril(rng.standard_normal((C, B, d, d))) + 4.0 * np.eye(d)
    return ljk, yk, b, ldiag


@pytest.mark.parametrize("ul", [1, 2, 17])
@pytest.mark.parametrize("B", [1, 7, 128])
@pytest.mark.parametrize("d", [3, 6])
def test_order_model_matches_twin(ul, B, d):
    rng = np.random.default_rng(100 * ul + 10 * B + d)
    args = _inputs(rng, 3, ul, B, d)
    bt, gu, uc = fwd_subst_geometry(3, ul, B, d, 8, H100_MIN_BLOCKS)
    got = model(*args, bt, gu, uc)
    want = fwd_stage(*(torch.as_tensor(a) for a in args)).run(level_fwd_subst_plain).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("ul,uc", [(70, 64), (70, 32), (40, 32)])
def test_chunked_order_model_matches_twin(ul, uc):
    """Lists staged in chunks of a multiple of gu = 32 keep each lane's
    order; the geometry picks such chunks only past the shared-memory
    limit, so the chunk is forced here."""
    rng = np.random.default_rng(ul + uc)
    args = _inputs(rng, 2, ul, 5, 6)
    got = model(*args, 1, 32, uc)
    np.testing.assert_array_equal(got, model(*args, 1, 32, ul))
    want = fwd_stage(*(torch.as_tensor(a) for a in args)).run(level_fwd_subst_plain).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
