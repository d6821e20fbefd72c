"""The launch geometry of the tile kernels (Between, Reprojection), on the CPU.

`csrc/between_se3.cu` and `csrc/reprojection.cu` give a block a contiguous
range of `threads` items (idx = k B + b): the block stages its input tiles
in shared memory and writes its outputs into a shared tile (Between: J1
and J2 rows padded to 37 values, err to 7; Reprojection: jpose's row padded
to 13, jpt's to 7, err's to 3) before coalesced stores, so it needs
BETWEEN_TILE or REPROJECTION_TILE values a thread of shared memory.
`_cuda.tile_geometry`, which `between_geometry` and `reprojection_geometry`
call with their tile, picks the block size: the largest that still gives
the launch min_blocks blocks (twice the card's SMs on the H100: 264).
The kernels run only on the card (tests/test_torch_cuda.py); here the
arithmetic of the launch.
"""

import pytest

from theseus_tpu_torch._cuda import TILE_THREADS_MAX, TILE_THREADS_MIN, tile_geometry
from theseus_tpu_torch.ops.between_se3 import BETWEEN_TILE, between_geometry
from theseus_tpu_torch.ops.reprojection import REPROJECTION_TILE, reprojection_geometry

H100_MIN_BLOCKS = 2 * 132
# the shared memory a block takes without opting in
SMEM_NO_OPT_IN = 48 * 1024


# (K B, itemsize) -> (threads, blocks, shared bytes): PGO 256 x 128 (257
# edges) and 64 x 16 (65 edges), float32 and float64, and a K B that is
# not a multiple of the block
@pytest.mark.parametrize("n,itemsize,want", [
    (257 * 128, 4, (64, 514, 81 * 64 * 4)),
    (257 * 128, 8, (64, 514, 81 * 64 * 8)),
    (65 * 16, 4, (64, 17, 81 * 64 * 4)),
    (65 * 16, 8, (64, 17, 81 * 64 * 8)),
    (10_000_003, 4, (256, 39063, 81 * 256 * 4)),
])
def test_geometry_at_main_path_shapes(n, itemsize, want):
    assert BETWEEN_TILE == 2 * 37 + 7
    assert between_geometry(n, itemsize, H100_MIN_BLOCKS) == want


def test_geometry_invariants():
    for n in (1, 31, 32, 1040, 33_000, 32_896, 10**6):
        for itemsize in (4, 8):
            threads, blocks, smem = between_geometry(n, itemsize, H100_MIN_BLOCKS)
            assert threads % 32 == 0 and TILE_THREADS_MIN <= threads <= TILE_THREADS_MAX
            assert (blocks - 1) * threads < n <= blocks * threads
            assert smem == BETWEEN_TILE * threads * itemsize <= 227 * 1024
            # the tile holds the 24 input values of a thread too
            assert BETWEEN_TILE >= 24
            # the block only shrinks below its cap to spread over the SMs
            if threads < TILE_THREADS_MAX:
                assert -(-n // (2 * threads)) < H100_MIN_BLOCKS


def ragged_shape(threads, min_blocks, batch=127):
    """(K, B) with K B just above min_blocks x threads: a K B that is a
    multiple of no block size, for which the geometry picks `threads`."""
    return min_blocks * threads // batch + 1, batch


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_geometry_picks_each_block(threads, itemsize):
    """Each block size the kernel takes is the one picked for some K B (the
    shapes tests/test_torch_cuda.py runs on the card), the last block
    ragged; the answer is cached."""
    k, b = ragged_shape(threads, H100_MIN_BLOCKS)
    n = k * b
    assert n % threads
    got = between_geometry(n, itemsize, H100_MIN_BLOCKS)
    assert got == (threads, n // threads + 1, BETWEEN_TILE * threads * itemsize)
    assert between_geometry(n, itemsize, H100_MIN_BLOCKS) is got


# Reprojection: (K B, itemsize) -> (threads, blocks, shared bytes). BA
# 128 x 4000 x 1 (204,800 observations) fills 2 blocks an SM at the largest
# block; BA 16 x 200 x 16 (1,466 observations x batch 16 = 23,456) only at
# the smallest; a K B that is a multiple of no block size (the chip check's
# ragged shape)
@pytest.mark.parametrize("n,itemsize,want", [
    (204_800, 4, (256, 800, 23 * 256 * 4)),
    (204_800, 8, (256, 800, 23 * 256 * 8)),
    (23_456, 4, (64, 367, 23 * 64 * 4)),
    (23_456, 8, (64, 367, 23 * 64 * 8)),
    (204_799, 4, (256, 800, 23 * 256 * 4)),
])
def test_reprojection_geometry_at_main_path_shapes(n, itemsize, want):
    assert REPROJECTION_TILE == 13 + 7 + 3
    assert reprojection_geometry(n, itemsize, H100_MIN_BLOCKS) == want


@pytest.mark.parametrize("itemsize", [4, 8])
def test_reprojection_geometry_invariants(itemsize):
    """The shared rule on the Reprojection tile: a block of a multiple of 32
    within the limits, every item covered once, 2 blocks an SM wherever the
    item count allows it, and the tile (which also holds the 15 input
    values of an item) within the 48 KB a block takes without opting in,
    float64 at the largest block included."""
    for n in (1, 31, 32, 1040, 16_896, 16_897, 23_456, 33_792, 67_584, 67_585, 204_800, 10**6):
        threads, blocks, smem = reprojection_geometry(n, itemsize, H100_MIN_BLOCKS)
        assert (threads, blocks, smem) == tile_geometry(n, itemsize, H100_MIN_BLOCKS, REPROJECTION_TILE)
        assert threads % 32 == 0 and TILE_THREADS_MIN <= threads <= TILE_THREADS_MAX
        assert (blocks - 1) * threads < n <= blocks * threads
        assert smem == REPROJECTION_TILE * threads * itemsize <= SMEM_NO_OPT_IN
        assert REPROJECTION_TILE >= 12 + 3
        if n >= H100_MIN_BLOCKS * TILE_THREADS_MIN:
            assert blocks >= H100_MIN_BLOCKS
        if threads < TILE_THREADS_MAX:
            assert -(-n // (2 * threads)) < H100_MIN_BLOCKS
    assert REPROJECTION_TILE * TILE_THREADS_MAX * 8 <= SMEM_NO_OPT_IN
