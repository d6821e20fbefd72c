"""The level backward substitution kernel's launch geometry and summation order, on the CPU.

`csrc/level_subst.cu`'s backward kernel gives a block to each (column, tile
of bt batch elements), stages the column's rows 1 .. rl - 1 (rc at a time,
in order), its diagonal blocks and y in shared memory, and gives d lanes to
each batch element: lane jj runs s = y[jj], then s -= L_r[i][jj] x_r[i]
over r = 1, 2, ... in order, i inner, keeping s across chunks; one thread
per batch element then solves L_jj^T x = s with the first design's
statements. The kernel runs only on the card (tests/test_torch_cuda.py);
here:

- the geometry `bwd_subst_geometry` at the PGO chain (256 x 128,
  2048 x 8) and grid (16 x 16 x 128) level shapes and its invariants over
  a grid of shapes;
- a numpy model of that order matches the plain twin
  `level_bwd_subst_plain` (the operands laid out behind the zero slot and
  read in place, `bwd_stage`) to 1e-12 in float64 at ragged shapes, with the
  row chunks forced small;
- the plain twin matches the JAX package's `bwd_sub_level` (Pallas,
  interpret mode) to 1e-12 in float64 at the grid's row counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.sparse.pallas_factorize import bwd_sub_level
from theseus_tpu_torch.sparse.level_kernels import (
    FWD_SMEM_MAX,
    FWD_THREADS_MAX,
    bwd_stage,
    bwd_subst_geometry,
    bwd_subst_smem,
    level_bwd_subst_plain,
)

# The H100's 132 SMs, two blocks each: the launch's floor of blocks there.
H100_MIN_BLOCKS = 264


# (C, rl, B, d, itemsize) -> (bt, rc): PGO 256 x 128 levels (widest (32, 3),
# (16, 3), the last two (1, 2), (1, 1)), 2048 x 8 (widest (256, 3)) and the
# 16 x 16 x 128 grid's head levels (first (118, 5), (25, 9), (15, 13),
# (9, 15), (5, 10), (4, 14), last (2, 15)) in float32 and float64, on the H100
@pytest.mark.parametrize("shape,want", [
    ((32, 3, 128, 6, 4), (8, 2)),
    ((32, 3, 128, 6, 8), (8, 2)),
    ((16, 3, 128, 6, 4), (4, 2)),
    ((1, 2, 128, 6, 4), (1, 1)),
    ((1, 1, 128, 6, 8), (1, 1)),
    ((256, 3, 8, 6, 4), (4, 2)),
    ((256, 3, 8, 6, 8), (4, 2)),
    ((118, 5, 128, 6, 4), (32, 4)),
    ((118, 5, 128, 6, 8), (32, 3)),
    ((25, 9, 128, 6, 4), (8, 8)),
    ((25, 9, 128, 6, 8), (8, 8)),
    ((15, 13, 128, 6, 4), (4, 12)),
    ((9, 15, 128, 6, 8), (4, 14)),
    ((5, 10, 128, 6, 4), (2, 9)),
    ((4, 14, 128, 6, 8), (1, 13)),
    ((2, 15, 128, 6, 4), (1, 14)),
    ((2, 15, 128, 6, 8), (1, 14)),
])
def test_geometry_at_main_path_shapes(shape, want):
    assert bwd_subst_geometry(*shape, H100_MIN_BLOCKS) == want


@pytest.mark.parametrize("min_blocks,want", [(1, (32, 4)), (500, (16, 4)), (945, (8, 4)),
                                             (100_000, (1, 4))])
def test_geometry_follows_the_cards_sms(min_blocks, want):
    """The grid's first head level (118 columns, 5 rows, batch 128, float32):
    the tile halves until the launch has min_blocks blocks."""
    assert bwd_subst_geometry(118, 5, 128, 6, 4, min_blocks) == want


def chunks(rl, rc):
    """(first row, rows) of each staged chunk, as the kernel walks them."""
    rows = rl - 1
    n = -(-rows // rc) if rows > 0 else 1
    return [(1 + k * rc, min(rc, rows - k * rc)) for k in range(n)]


@pytest.mark.parametrize("d,itemsize", [(3, 4), (6, 4), (6, 8), (8, 8)])
def test_geometry_invariants(d, itemsize):
    for C in (1, 2, 5, 32, 118, 4096):
        for rl in (1, 2, 3, 5, 15, 41, 400):
            for B in (1, 3, 33, 127, 128, 1000):
                bt, rc = bwd_subst_geometry(C, rl, B, d, itemsize, H100_MIN_BLOCKS)
                assert 1 <= bt <= B and rc >= 1
                assert bt * d <= FWD_THREADS_MAX
                assert bwd_subst_smem(bt, rc, d, itemsize) <= FWD_SMEM_MAX
                # the chunks cover rows 1 .. rl - 1 once, in order
                covered = [r0 + k for r0, n in chunks(rl, rc) for k in range(n)]
                assert covered == list(range(1, rl))
                # one chunk, or as many rows as the budget holds
                assert rc == max(rl - 1, 1) or bwd_subst_smem(bt, rc + 1, d, itemsize) > FWD_SMEM_MAX
                # bt only shrinks below the tile cap for a reason
                if bt < min(B, 32):
                    nb = C * -(-B // (2 * bt))
                    assert (2 * bt * d > FWD_THREADS_MAX or nb < H100_MIN_BLOCKS
                            or bwd_subst_smem(2 * bt, 1, d, itemsize) > FWD_SMEM_MAX)


def test_smem_slots_are_16_byte_multiples():
    """Every shared-memory slot starts 16-byte aligned (the 16-byte
    cp.async copies need it): a slot of bt d x d blocks and one of bt
    d-vectors, each rounded up."""
    assert bwd_subst_smem(1, 1, 6, 4) == 2 * (36 + 8) * 4
    assert bwd_subst_smem(1, 1, 5, 8) == 2 * (26 + 6) * 8
    assert bwd_subst_smem(32, 4, 6, 4) == 5 * (32 * 36 + 32 * 6) * 4
    for bt in (1, 2, 3, 8):
        for d in range(1, 9):
            for itemsize in (4, 8):
                assert bwd_subst_smem(bt, 0, d, itemsize) % 16 == 0


def model(lcol, xr, y, bt, rc):
    """The kernel's order in numpy, tile by tile (vectorised over columns,
    the tile's batch elements and the d lanes)."""
    C, rl, B, d, _ = lcol.shape
    out = np.empty_like(y)
    for b0 in range(0, B, bt):
        tile = slice(b0, min(b0 + bt, B))
        s = y[:, tile].copy()
        for r0, n in chunks(rl, rc):
            for r in range(r0, r0 + n):
                for i in range(d):
                    s = s - lcol[:, r, tile, i, :] * xr[:, r, tile, i, None]
        l0 = lcol[:, 0, tile]
        x = np.zeros_like(s)
        for j in reversed(range(d)):
            t = s[..., j]
            for k in range(j + 1, d):
                t = t - l0[..., k, j] * x[..., k]
            x[..., j] = t / l0[..., j, j]
        out[:, tile] = x
    return out


def _inputs(rng, C, rl, B, d):
    lcol = rng.standard_normal((C, rl, B, d, d))
    lcol[:, 0] = np.tril(lcol[:, 0]) + 4.0 * np.eye(d)
    xr = rng.standard_normal((C, rl, B, d))
    y = rng.standard_normal((C, B, d))
    return lcol, xr, y


@pytest.mark.parametrize("rl", [1, 2, 5, 15])
@pytest.mark.parametrize("B", [3, 33, 127])
@pytest.mark.parametrize("d", [3, 6])
def test_order_model_matches_twin(rl, B, d):
    rng = np.random.default_rng(100 * rl + 10 * B + d)
    args = _inputs(rng, 3, rl, B, d)
    bt, rc = bwd_subst_geometry(3, rl, B, d, 8, H100_MIN_BLOCKS)
    got = model(*args, bt, rc)
    want = bwd_stage(*(torch.as_tensor(a) for a in args)).run(level_bwd_subst_plain).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("rl,rc", [(15, 1), (15, 4), (9, 3), (5, 2)])
@pytest.mark.parametrize("bt", [1, 8, 32])
def test_chunked_order_model_matches_twin(rl, rc, bt):
    """Rows staged a few at a time keep each lane's order: the same bits as
    one chunk. The geometry picks chunks only past the shared-memory
    budget, so the chunk is forced here."""
    rng = np.random.default_rng(rl + rc + bt)
    args = _inputs(rng, 2, rl, 33, 6)
    got = model(*args, bt, rc)
    np.testing.assert_array_equal(got, model(*args, bt, rl - 1))
    want = bwd_stage(*(torch.as_tensor(a) for a in args)).run(level_bwd_subst_plain).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("C,rl,B", [(4, 5, 33), (3, 9, 17), (2, 15, 33)])
def test_twin_matches_jax_interpret_kernel(C, rl, B):
    """The JAX package's `bwd_sub_level` in Pallas interpret mode, on the
    same float64 inputs in its layout ((C, rl, d*d, B), (C, rl, d, B),
    (C, d, B)), against the plain twin in the port's ((C, rl, B, d, d), ...):
    1e-12 relative to the largest entry. Padded rows are zero, as the
    plain twin's `bwd_operands` gathers them."""
    d = 6
    rng = np.random.default_rng(C * rl + B)
    lcol, xr, y = _inputs(rng, C, rl, B, d)
    lcol[:, -1, : B // 2] = 0.0
    xr[:, -1, : B // 2] = 0.0
    jl = jnp.asarray(lcol.transpose(0, 1, 3, 4, 2).reshape(C, rl, d * d, B))
    jx = jnp.asarray(xr.transpose(0, 1, 3, 2))
    jy = jnp.asarray(y.transpose(0, 2, 1))
    want = np.asarray(bwd_sub_level(jl, jx, jy, d, interpret=True)).transpose(0, 2, 1)
    got = bwd_stage(*(torch.as_tensor(a) for a in (lcol, xr, y))).run(level_bwd_subst_plain).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(model(lcol, xr, y, 1, 1), want, atol=1e-12 * np.abs(want).max(), rtol=0)
