"""Operations and bytes of one launch of each counted kernel, from the
cell's shapes alone: each input byte read once, each output byte written
once, at the true sizes of the blocks (a variable's own dof, not a padded
width).
"""

from __future__ import annotations

from . import symbolic

# Between (SE3): per edge, two poses and a measurement in (3 x 4 each), two
# 6 x 6 jacobians and a 6-vector out; ~800 operations of composes, one log
# and its inverse right jacobian and one adjoint (a hand count).
BETWEEN_IN, BETWEEN_OUT, BETWEEN_FLOPS = 36, 78, 800


def between(shapes, itemsize: int):
    kb = shapes["between"] * shapes["batch"]
    return BETWEEN_FLOPS * kb, (BETWEEN_IN + BETWEEN_OUT) * kb * itemsize


def _cost_terms(shapes):
    """[(count, residual dim, dofs of its variables)] of every cost the
    assembly takes."""
    return [(shapes["between"], 6, (6, 6)), (shapes["local"], 6, (6,))]


def assemble(shapes, itemsize: int):
    """Jacobians and errors read once; the lower blocks of AtA (each
    variable's diagonal block, each coupled pair's block) and Atb written
    once. Operations: each cost's J_a^T J_b for a <= b and J^T e."""
    b = shapes["batch"]
    flops = read = 0
    for count, m, dofs in _cost_terms(shapes):
        read += count * (m * sum(dofs) + m)
        for x in range(len(dofs)):
            flops += count * 2 * m * dofs[x]
            for y in range(x, len(dofs)):
                flops += count * 2 * m * dofs[x] * dofs[y]
    written = shapes["n_vars"] * (36 + 6) + len({tuple(sorted(p)) for p in shapes["pairs"]}) * 36
    return flops * b, (read + written) * b * itemsize


def factor(shapes, itemsize: int):
    """The whole numeric block Cholesky of the cell's normal equations on
    the frozen pattern (counts/symbolic.py), head and dense tail: A's lower
    blocks read once and L's blocks written once; per head column with r
    rows, d^3/3 for its diagonal block, (r - 1) d^3 for the blocks below it
    and 2 d^3 for each block product it sends to a later column, head or
    tail (every pair r1 >= r2 of its rows below the diagonal); the dense
    tail of k columns, (k d)^3 / 3."""
    d, n, b = shapes["d"], shapes["n_vars"], shapes["batch"]
    col_rows, start = symbolic.auto_pattern(n, shapes["pairs"], d)
    flops = 0.0
    for j in range(start):
        r = len(col_rows[j]) - 1
        flops += d ** 3 / 3 + r * d ** 3 + 2 * (r * (r + 1) // 2) * d ** 3
    flops += ((n - start) * d) ** 3 / 3
    nnz_a = n + len({tuple(sorted(p)) for p in shapes["pairs"]})
    nnz_l = sum(len(r) for r in col_rows)
    return flops * b, (nnz_a + nnz_l) * d * d * b * itemsize
