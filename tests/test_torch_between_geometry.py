"""The Between kernel's launch geometry, on the CPU.

`csrc/between_se3.cu` gives a block a contiguous range of `threads` items
(idx = k B + b): the block stages its v1 and v2 tiles in shared memory and
writes its outputs into a shared tile (J1 and J2 rows padded to 37 values,
err to 7) before coalesced stores, so it needs BETWEEN_TILE values a thread
of shared memory. `between_geometry` picks the block size: the largest
that still gives the launch min_blocks blocks (twice the card's SMs on the
H100: 264).
The kernel runs only on the card (tests/test_torch_cuda.py); here the
arithmetic of the launch.
"""

import pytest

from theseus_tpu_torch.ops.between_se3 import (
    BETWEEN_THREADS_MAX,
    BETWEEN_THREADS_MIN,
    BETWEEN_TILE,
    between_geometry,
)

H100_MIN_BLOCKS = 2 * 132


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
            assert threads % 32 == 0 and BETWEEN_THREADS_MIN <= threads <= BETWEEN_THREADS_MAX
            assert (blocks - 1) * threads < n <= blocks * threads
            assert smem == BETWEEN_TILE * threads * itemsize <= 227 * 1024
            # the tile holds the 24 input values of a thread too
            assert BETWEEN_TILE >= 24
            # the block only shrinks below its cap to spread over the SMs
            if threads < BETWEEN_THREADS_MAX:
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
