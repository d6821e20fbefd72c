"""The frozen counts against hand counts on tiny patterns."""

import pytest

from portbench.configs.pgo_se3_sphere2500 import grid_edges
from portbench.counts import kernels, peaks, symbolic

D = 6
CHAIN = {"d": D, "batch": 3, "n_vars": 3, "pairs": [(0, 1), (1, 2)], "between": 2, "local": 1}


def test_factor_on_a_three_pose_chain():
    # columns 0 and 1 each: a diagonal block d^3/3, one block below (d^3)
    # and one product to the next column (2 d^3); column 2: d^3/3
    flops, nbytes = kernels.factor(CHAIN, 4)
    assert flops == pytest.approx(3 * 7 * D ** 3)
    # A: 3 diagonal blocks and 2 couplings; L: 5 blocks
    assert nbytes == (5 + 5) * D * D * 3 * 4


def test_between_and_assemble_on_a_three_pose_chain():
    flops, nbytes = kernels.between(CHAIN, 4)
    assert (flops, nbytes) == (800 * 2 * 3, (36 + 78) * 2 * 3 * 4)
    flops, nbytes = kernels.assemble(CHAIN, 4)
    # each Between: J^T e for 2 poses (2 x 72) and 3 J_a^T J_b (3 x 432);
    # the prior: 72 + 432
    assert flops == (2 * (144 + 1296) + 504) * 3
    # read: 2 x (two 6x6 jacobians and a 6-vector) + (one and a 6-vector);
    # written: 3 diagonal blocks with their Atb, 2 coupling blocks
    assert nbytes == (2 * 78 + 42 + 3 * 42 + 2 * 36) * 3 * 4


def test_factor_counts_the_products_into_a_dense_tail():
    # a star: pose 0 joined to 20 others, ordered last; the 20 leaves are
    # head columns with one row below each, and the hub alone cannot be a
    # tail (under TAIL_MIN_K), so K4-like cliques are joined to make one
    pairs = [(i, j) for i in range(16) for j in range(i + 1, 16)] + [(16 + k, k) for k in range(4)]
    col_rows, start = symbolic.auto_pattern(20, pairs, D)
    assert start < 20
    flops, _ = kernels.factor({"d": D, "batch": 1, "n_vars": 20, "pairs": pairs}, 4)
    head = sum(D ** 3 / 3 + (len(c) - 1) * D ** 3 + (len(c) - 1) * len(c) * D ** 3 for c in col_rows[:start])
    assert flops == pytest.approx(head + ((20 - start) * D) ** 3 / 3)
    # every head column here sends its products into the tail
    assert all(min(c[1:]) >= start for c in col_rows[:start] if len(c) > 1)


def test_frozen_pattern_of_the_sphere2500_grid():
    edges, _ = grid_edges(50, 50)
    col_rows, start = symbolic.auto_pattern(2500, edges, D)
    assert 2500 - start == 123
    assert sum(len(r) for r in col_rows) == 43617
    assert len([lv for lv in symbolic.levels(col_rows, start) if len(lv)]) == 94


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
