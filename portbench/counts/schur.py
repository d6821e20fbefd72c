"""Operations and bytes of the useful work of one Schur elimination and
reduction, from the cell's shapes: the camera pairs the program's builder
counts (`pair_counts()`, read by the problem's `shapes()` as
"pairs_useful": the sum over points of k^2 for a point seen by k cameras),
each a W_a H_b^T product of a (dc x dp) and a (dp x dc) block; the W and
Hcp blocks (one per observation, dc x dp) read once and S (C dc square)
written once. Hpp's Choleskys and W's own solves are left out (a few
percent of the operations)."""

from __future__ import annotations


def reduction(shapes, itemsize: int):
    dc, dp, b = shapes["dc"], shapes["dp"], shapes["batch"]
    flops = shapes["pairs_useful"] * 2 * dc * dc * dp
    nbytes = (2 * shapes["n_obs"] * dc * dp + (shapes["n_cams"] * dc) ** 2) * itemsize
    return flops * b, nbytes * b
