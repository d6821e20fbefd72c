"""Symbolic analysis for the batched block-sparse Cholesky (JAX counterpart: theseus_tpu/sparse/structure.py).

A numpy-only copy of the JAX package's symbolic layer: block adjacency,
fill-reducing orderings (ND, AMD, RCM), the elimination pattern, the etree
levels and the dense-tail choice. For the "natural", "amd" and "nd"
orderings the ordering and the fill come from the C++ analysis in
`native/` (a copy of the JAX package's, built with g++ at first use), as
in the JAX package; the pure-Python analysis here is its twin, run with
`native=False`, for "rcm" and for explicit permutations. Copied rather
than imported because importing anything from `theseus_tpu` imports jax.
The tables it produces are held equal to the JAX package's by the tests.

Layout: n variables, each padded to a uniform block dof `d`. The factor L is
stored as a flat array of blocks (nnzL+1, B, d, d); slot 0 is a zero
sentinel for masked gathers and a scratch target for masked scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np


def rcm_ordering(n: int, pairs: Set[Tuple[int, int]]) -> np.ndarray:
    """Reverse Cuthill-McKee on the block adjacency (scipy-backed)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if not pairs:
        return np.arange(n)
    rows, cols = zip(*pairs)
    a = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n)
    ).tocsr()
    a = a + a.T
    perm = reverse_cuthill_mckee(a, symmetric_mode=True)
    return np.asarray(perm)


def nd_ordering(n: int, pairs: Set[Tuple[int, int]], leaf_size: int = 8) -> np.ndarray:
    """Nested dissection by recursive BFS bisection.

    ND makes the elimination tree shallow and balanced, so the
    level-scheduled factorization (sparse/cholesky.py) eliminates O(n/2^k)
    columns per level with one batched kernel launch instead of a length-n
    sequential sweep. Separators are ordered last. BFS from a
    pseudo-peripheral vertex picks the middle level set as separator —
    adequate for the chain/grid/mesh graphs of PGO/BA problems."""
    adj: List[Set[int]] = [set() for _ in range(n)]
    for i, j in pairs:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)

    def bfs_order(nodes: Set[int], start: int):
        seen = {start}
        frontier = [start]
        levels = [[start]]
        while frontier:
            nxt = []
            for u in frontier:
                for v in sorted(adj[u]):  # deterministic (matches native)
                    if v in nodes and v not in seen:
                        seen.add(v)
                        nxt.append(v)
            if nxt:
                levels.append(nxt)
            frontier = nxt
        return levels, seen

    def rec(nodes: Set[int]) -> List[int]:
        if len(nodes) <= leaf_size:
            return sorted(nodes)
        start = min(nodes)
        levels, seen = bfs_order(nodes, start)
        missing = nodes - seen  # disconnected pieces
        if missing:
            return rec(seen) + rec(missing)
        # pseudo-peripheral: restart BFS from a farthest node
        levels, _ = bfs_order(nodes, levels[-1][0])
        if len(levels) < 3:
            return sorted(nodes)  # near-clique: give up splitting
        mid = len(levels) // 2
        sep = set(levels[mid])
        left = set().union(*levels[:mid])
        right = set().union(*levels[mid + 1:]) if mid + 1 < len(levels) else set()
        return rec(left) + rec(right) + sorted(sep)

    order = rec(set(range(n)))
    return np.asarray(order)


def amd_ordering(n: int, pairs: Set[Tuple[int, int]]) -> np.ndarray:
    """Approximate-minimum-degree-style greedy ordering (pure Python).

    A simple exact-degree greedy MD with element absorption — adequate for
    setup-time use at the problem sizes the block solver targets."""
    adj: List[Set[int]] = [set() for _ in range(n)]
    for i, j in pairs:
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    alive = set(range(n))
    perm = []
    while alive:
        j = min(alive, key=lambda v: (len(adj[v] & alive), v))
        perm.append(j)
        alive.discard(j)
        nbrs = adj[j] & alive
        for u in nbrs:
            adj[u] |= nbrs
            adj[u].discard(u)
    return np.asarray(perm)


@dataclasses.dataclass
class SymbolicFactor:
    """Static factorization schedule (all numpy, trace-time constants)."""

    n: int  # number of block columns
    d: int  # uniform block dof
    perm: np.ndarray  # (n,) new-order -> old-var
    iperm: np.ndarray  # (n,) old-var -> new-order
    # lower-triangle pattern of L in permuted order
    col_rows: List[np.ndarray]  # per column j: sorted rows (including j first)
    nnz_l: int
    rmax: int  # max blocks per column
    umax: int  # max left-looking updates per column
    # flat-slot tables, shapes (n, rmax) / (n, umax, rmax) / (n, umax)
    # left-looking update columns per HEAD column j (k < j with (j,k) in L);
    # rectangular gather tables are built lazily in NumericSchedule
    upd_lists: List[List[int]]
    # solve schedules
    block_of: Dict[Tuple[int, int], int]  # (row, col) -> slot (lower tri)
    etree_parent: np.ndarray = None  # (n,) parent column or -1
    levels: list = None  # list of np arrays: columns per elimination level
    # supernodal dense tail (config.SPARSE_DENSE_TAIL): columns
    # tail_start..n-1 form one dense trailing supernode — their col_rows are
    # amalgamated to the full trailing set and the numeric layer factors
    # them with ONE batched dense POTRF. levels cover head columns only.
    tail_start: int = -1  # == n when no tail
    # per tail column: EXTERNAL (head, k < tail_start) update columns.
    # Stored as lists, not rectangular tables: at 10k+ columns the tail's
    # update fan-in would inflate (n, umax, rmax) tables to gigabytes.
    tail_ext_upd: list = None


def _choose_tail(n: int, col_rows, d: int) -> int:
    """Size of the trailing dense supernode: walk from the last column while
    the trailing-submatrix block pattern stays dense enough. All rows of
    column j satisfy r >= j, so the trailing k columns' patterns lie fully
    inside the trailing k x k submatrix."""
    from .. import config as _config

    if not _config.SPARSE_DENSE_TAIL:
        return 0
    density_min = _config.SPARSE_TAIL_DENSITY
    max_dim = _config.SPARSE_TAIL_MAX_DIM
    min_k = _config.SPARSE_TAIL_MIN_K
    best = 0
    nnz = 0
    for k in range(1, n + 1):
        j = n - k
        if k * d > max_dim:
            break
        nnz += len(col_rows[j])
        density = nnz / (k * (k + 1) / 2)
        if density < density_min:
            break
        if k >= min_k:
            best = k
    return best


def _score_symbolic(sym: "SymbolicFactor") -> float:
    """Estimated device cost in block-op units for ranking orderings.

    The JAX package's cost model, kept unchanged so that "auto" picks the
    same ordering in both packages: each level sweep pays a fixed dispatch
    cost plus padded volume C_l*(ul*rl + rl); the dense tail pays K^3/3.
    AMD minimizes fill but makes chain-like graphs level-deep
    (dispatch-bound); ND keeps levels
    log-shallow but produces catastrophic fill on bipartite (BA-like)
    graphs — the score picks the right one per graph."""
    DISPATCH = 2000.0
    score = 0.0
    for cols in sym.levels:
        rl = max(len(sym.col_rows[int(j)]) for j in cols)
        ul = max(1, max(len(sym.upd_lists[int(j)]) for j in cols))
        score += len(cols) * (ul * rl + rl) + DISPATCH
    K = sym.n - sym.tail_start
    if K > 0:
        score += K**3 / 3.0 + DISPATCH
    return score


def symbolic_factor_auto(
    n: int,
    pairs: Set[Tuple[int, int]],
    d: int,
    candidates: Sequence[str] = ("nd", "amd"),
) -> SymbolicFactor:
    """Try candidate orderings, keep the lowest-cost symbolic factorization
    (ties keep the earlier candidate)."""
    best = None
    for o in candidates:
        s = symbolic_factor(n, pairs, d, o)
        sc = _score_symbolic(s)
        if best is None or sc < best[0]:
            best = (sc, s)
    return best[1]


def symbolic_factor(
    n: int,
    pairs: Set[Tuple[int, int]],
    d: int,
    ordering="amd",
    native: bool = True,
) -> SymbolicFactor:
    """Compute fill pattern + static left-looking schedule.

    pairs: set of undirected off-diagonal block pairs (i, j), original ids.
    ordering: strategy string ("amd" | "rcm" | "nd" | "natural") or an
    explicit permutation array (perm[k] = original id of the k-th eliminated
    variable — the user-facing `VariableOrdering` path,
    reference optimizer/variable_ordering.py:11).

    native: the ordering, the fill and the etree of "natural", "amd" and
    "nd" on a graph with edges come from the g++-built `native/` library
    (as in the JAX package); False runs the pure-Python analysis, its twin.
    "rcm", explicit permutations and edgeless graphs always run in Python.
    A failed native build raises; nothing falls back."""
    explicit_perm = not isinstance(ordering, str)
    if explicit_perm:
        ordering = np.asarray(ordering, dtype=np.int64)
        if sorted(ordering.tolist()) != list(range(n)):
            raise ValueError("explicit ordering must be a permutation of 0..n-1")
    if native and not explicit_perm and ordering in ("natural", "amd", "nd") and pairs:
        from ..native import native_symbolic

        perm, col_rows, _, _ = native_symbolic(n, pairs, ordering)
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)
    else:
        if explicit_perm:
            perm = ordering
        elif ordering == "amd":
            perm = amd_ordering(n, pairs)
        elif ordering == "rcm":
            perm = rcm_ordering(n, pairs)
        elif ordering == "nd":
            perm = nd_ordering(n, pairs)
        elif ordering == "natural":
            perm = np.arange(n)
        else:
            raise ValueError(f"unknown ordering {ordering}")
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)

        # permuted adjacency, lower triangle: for each column, rows > col
        below: List[Set[int]] = [set() for _ in range(n)]
        for i, j in pairs:
            pi, pj = iperm[i], iperm[j]
            lo, hi = (pi, pj) if pi < pj else (pj, pi)
            if lo != hi:
                below[lo].add(hi)

        # symbolic fill via the standard elimination-pattern recurrence:
        # pattern(j) ⊇ rows of A below j, plus pattern(k)\{j} for each child k
        # (children = columns whose first below-diagonal row is j)
        pattern: List[Set[int]] = [set(below[j]) for j in range(n)]
        for j in range(n):
            if pattern[j]:
                parent = min(pattern[j])
                pattern[parent] |= pattern[j] - {parent}

        col_rows = []
        for j in range(n):
            rows = np.array([j] + sorted(pattern[j]), dtype=np.int64)
            col_rows.append(rows)

    # supernodal amalgamation: force the trailing dense supernode's columns
    # to full trailing patterns (structural fill is the price of the single
    # dense POTRF; on near-dense tails it is tiny)
    tail_k = _choose_tail(n, col_rows, d)
    tail_start = n - tail_k
    if tail_k >= 2:
        for j in range(tail_start, n):
            col_rows[j] = np.arange(j, n, dtype=np.int64)

    # flat slot ids: slot 0 reserved as sentinel/scratch
    block_of: Dict[Tuple[int, int], int] = {}
    slot = 1
    for j in range(n):
        for r in col_rows[j]:
            block_of[(int(r), j)] = slot
            slot += 1
    nnz_l = slot - 1

    # left-looking updates: for column j, every k < j with (j, k) in L.
    # Stored as LISTS; the rectangular gather tables are built lazily (and
    # only per level / per plan) by NumericSchedule — padding everything to
    # the fattest column's (umax, rmax) here would cost gigabytes at 10k+
    # columns.
    nh = tail_start
    upd_lists: List[List[int]] = [[] for _ in range(n)]
    for k in range(nh):  # tail-internal updates are subsumed by the POTRF
        for r in col_rows[k][1:]:
            upd_lists[int(r)].append(k)
    tail_ext_upd = [upd_lists[nh + j] for j in range(tail_k)]

    rmax = max((len(col_rows[j]) for j in range(nh)), default=1)
    umax = max(1, max((len(upd_lists[j]) for j in range(nh)), default=1))

    # elimination tree + level schedule: parent(j) = first below-diag row of
    # column j; level(j) = 1 + max(level(children)); columns within a level
    # are mutually independent (no ancestor relation), enabling batched
    # elimination per level
    etree_parent = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        if len(col_rows[j]) > 1:
            etree_parent[j] = int(col_rows[j][1])
    level_of = np.zeros(n, dtype=np.int64)
    for j in range(n):  # children have smaller index, already assigned
        p = etree_parent[j]
        if p >= 0:
            level_of[p] = max(level_of[p], level_of[j] + 1)
    n_levels = int(level_of.max()) + 1 if n else 0
    # levels drive the batched per-level sweeps; the dense tail is handled
    # by one POTRF instead, so its columns are excluded
    levels = [
        lv
        for l in range(n_levels)
        for lv in [np.where((level_of == l) & (np.arange(n) < tail_start))[0]]
        if len(lv)
    ]

    return SymbolicFactor(
        n=n,
        d=d,
        perm=perm,
        iperm=iperm,
        col_rows=col_rows,
        nnz_l=nnz_l,
        rmax=rmax,
        umax=umax,
        upd_lists=upd_lists,
        block_of=block_of,
        etree_parent=etree_parent,
        levels=levels,
        tail_start=tail_start,
        tail_ext_upd=tail_ext_upd,
    )
