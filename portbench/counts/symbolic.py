"""The benchmark's frozen copy of the block-Cholesky symbolic analysis.

Copied from the program's pure-Python analysis (sparse/structure.py,
`symbolic_factor(..., native=False)` under the "auto" ordering) as it
stood when the benchmark was written, with the dense-tail thresholds of
that day as constants, so that a later change to the program's plan does
not move the yardstick the factor roofline is measured with. It gives the
pattern of L: the columns in elimination order, each column's rows, and the
trailing dense supernode.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

TAIL_DENSITY = 0.6
TAIL_MAX_DIM = 2048
TAIL_MIN_K = 16
DISPATCH = 2000.0  # the ordering score's cost of one level


def _adjacency(n, pairs):
    adj: List[Set[int]] = [set() for _ in range(n)]
    for i, j in pairs:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    return adj


def nd_ordering(n: int, pairs, leaf_size: int = 8) -> np.ndarray:
    """Nested dissection by recursive BFS bisection, separators last."""
    adj = _adjacency(n, pairs)

    def bfs_order(nodes, start):
        seen, frontier, levels = {start}, [start], [[start]]
        while frontier:
            nxt = []
            for u in frontier:
                for v in sorted(adj[u]):
                    if v in nodes and v not in seen:
                        seen.add(v)
                        nxt.append(v)
            if nxt:
                levels.append(nxt)
            frontier = nxt
        return levels, seen

    def rec(nodes):
        if len(nodes) <= leaf_size:
            return sorted(nodes)
        levels, seen = bfs_order(nodes, min(nodes))
        missing = nodes - seen
        if missing:
            return rec(seen) + rec(missing)
        levels, _ = bfs_order(nodes, levels[-1][0])
        if len(levels) < 3:
            return sorted(nodes)
        mid = len(levels) // 2
        left = set().union(*levels[:mid])
        right = set().union(*levels[mid + 1:]) if mid + 1 < len(levels) else set()
        return rec(left) + rec(right) + sorted(levels[mid])

    return np.asarray(rec(set(range(n))))


def amd_ordering(n: int, pairs) -> np.ndarray:
    """Exact-degree greedy minimum degree with element absorption."""
    adj = _adjacency(n, pairs)
    alive, perm = set(range(n)), []
    while alive:
        j = min(alive, key=lambda v: (len(adj[v] & alive), v))
        perm.append(j)
        alive.discard(j)
        nbrs = adj[j] & alive
        for u in nbrs:
            adj[u] |= nbrs
            adj[u].discard(u)
    return np.asarray(perm)


def _choose_tail(n, col_rows, d):
    best, nnz = 0, 0
    for k in range(1, n + 1):
        if k * d > TAIL_MAX_DIM:
            break
        nnz += len(col_rows[n - k])
        if nnz / (k * (k + 1) / 2) < TAIL_DENSITY:
            break
        if k >= TAIL_MIN_K:
            best = k
    return best


def pattern(n: int, pairs: Set[Tuple[int, int]], d: int, ordering: str):
    """(col_rows, tail_start): the rows of each column of L in elimination
    order (the diagonal first), and the first column of the dense tail (n
    when there is none)."""
    perm = nd_ordering(n, pairs) if ordering == "nd" else amd_ordering(n, pairs)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    below: List[Set[int]] = [set() for _ in range(n)]
    for i, j in pairs:
        lo, hi = sorted((int(iperm[i]), int(iperm[j])))
        if lo != hi:
            below[lo].add(hi)
    pat = [set(b) for b in below]
    for j in range(n):
        if pat[j]:
            parent = min(pat[j])
            pat[parent] |= pat[j] - {parent}
    col_rows = [[j] + sorted(pat[j]) for j in range(n)]
    tail = _choose_tail(n, col_rows, d)
    start = n - tail
    if tail >= 2:
        for j in range(start, n):
            col_rows[j] = list(range(j, n))
    return col_rows, start


def levels(col_rows, tail_start):
    """The elimination-tree levels of the head columns."""
    n = len(col_rows)
    level = np.zeros(n, dtype=np.int64)
    for j in range(n):
        if len(col_rows[j]) > 1:
            p = col_rows[j][1]
            level[p] = max(level[p], level[j] + 1)
    return [np.flatnonzero((level == lv) & (np.arange(n) < tail_start)) for lv in range(int(level.max()) + 1)]


def _score(col_rows, tail_start):
    upd = [0] * len(col_rows)
    for k in range(tail_start):
        for r in col_rows[k][1:]:
            upd[r] += 1
    score = 0.0
    for cols in levels(col_rows, tail_start):
        if len(cols):
            rl = max(len(col_rows[j]) for j in cols)
            ul = max(1, max(upd[j] for j in cols))
            score += len(cols) * (ul * rl + rl) + DISPATCH
    k = len(col_rows) - tail_start
    if k > 0:
        score += k ** 3 / 3.0 + DISPATCH
    return score


def auto_pattern(n: int, pairs, d: int):
    """The "auto" choice: of nested dissection and minimum degree, the
    pattern with the lower score (ties keep nested dissection)."""
    pairs = {tuple(sorted((int(i), int(j)))) for i, j in pairs}
    best = None
    for o in ("nd", "amd"):
        col_rows, start = pattern(n, pairs, d, o)
        sc = _score(col_rows, start)
        if best is None or sc < best[0]:
            best = (sc, col_rows, start)
    return best[1], best[2]
