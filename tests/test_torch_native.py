"""The native (g++-built) symbolic analysis of theseus_tpu_torch against its pure-Python twin and the JAX package's native path, on the CPU.

For a chain with loop closures, a grid and a Manhattan graph of
scripts/manhattan_g2o.py (200 poses, seed 0), under the "amd", "nd" and
"natural" orderings, `symbolic_factor` through `native/` gives tables
equal, entry for entry, to the pure-Python analysis (`native=False`) and
to the JAX package's `symbolic_factor` (whose native path these orderings
take): the permutation, every column's rows, the slot map, the update
lists, the elimination tree, the levels and the dense tail. "rcm" and an
explicit permutation never reach the library. A build with a compiler
that does not exist raises with the reason; nothing falls back.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from theseus_tpu.sparse import structure as jstruct
import theseus_tpu_torch.native as native
from theseus_tpu_torch.sparse import structure as tstruct

ROOT = Path(__file__).resolve().parents[1]
ORDERINGS = ("amd", "nd", "natural")


def _chain(n=60):
    return n, {(i, i + 1) for i in range(n - 1)} | {(n - 1, 0), (0, n // 2), (5, 2 * n // 3)}


def _grid(r=9, c=11):
    pairs = set()
    for i in range(r):
        for j in range(c):
            k = i * c + j
            if j + 1 < c:
                pairs.add((k, k + 1))
            if i + 1 < r:
                pairs.add((k, k + c))
    return r * c, pairs


def _manhattan(poses=200):
    spec = importlib.util.spec_from_file_location("manhattan_g2o", ROOT / "scripts" / "manhattan_g2o.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    edges = mod.generate(poses, 0)["edges"]
    return poses, {(int(min(i, j)), int(max(i, j))) for i, j in edges if i != j}


GRAPHS = {"chain": _chain, "grid": _grid, "manhattan200": _manhattan}


def _tables(sym):
    return {
        "perm": np.asarray(sym.perm).tolist(),
        "iperm": np.asarray(sym.iperm).tolist(),
        "col_rows": [np.asarray(c).tolist() for c in sym.col_rows],
        "nnz_l": sym.nnz_l,
        "block_of": dict(sym.block_of),
        "upd_lists": [list(map(int, u)) for u in sym.upd_lists],
        "etree_parent": np.asarray(sym.etree_parent).tolist(),
        "levels": [np.asarray(lv).tolist() for lv in sym.levels],
        "tail_start": sym.tail_start,
        "tail_ext_upd": [list(map(int, u)) for u in sym.tail_ext_upd],
        "rmax": sym.rmax,
        "umax": sym.umax,
    }


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_native_tables_equal_python_twin_and_jax(graph, ordering):
    n, pairs = GRAPHS[graph]()
    d = 3
    got = _tables(tstruct.symbolic_factor(n, pairs, d, ordering))
    twin = _tables(tstruct.symbolic_factor(n, pairs, d, ordering, native=False))
    want = _tables(jstruct.symbolic_factor(n, pairs, d, ordering))
    for key in got:
        assert got[key] == twin[key], f"{key}: native differs from the Python twin"
        assert got[key] == want[key], f"{key}: differs from the JAX package"


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_native_symbolic_etree_levels(ordering):
    n, pairs = _grid()
    perm, cols, etree, level_of = native.native_symbolic(n, pairs, ordering)
    assert sorted(perm.tolist()) == list(range(n))
    for j in range(n):
        assert cols[j][0] == j and list(cols[j]) == sorted(cols[j])
        assert etree[j] == (cols[j][1] if len(cols[j]) > 1 else -1)
        if etree[j] >= 0:
            assert level_of[etree[j]] > level_of[j]


def test_rcm_and_explicit_permutations_stay_in_python(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native library was called")

    monkeypatch.setattr(native, "native_symbolic", refuse)
    n, pairs = _grid(5, 6)
    rcm = tstruct.symbolic_factor(n, pairs, 2, "rcm")
    assert _tables(rcm) == _tables(jstruct.symbolic_factor(n, pairs, 2, "rcm"))
    perm = np.random.default_rng(0).permutation(n)
    assert _tables(tstruct.symbolic_factor(n, pairs, 2, perm)) == _tables(jstruct.symbolic_factor(n, pairs, 2, perm))
    with pytest.raises(AssertionError, match="native library"):
        tstruct.symbolic_factor(n, pairs, 2, "amd")


def test_bad_compiler_raises_with_reason(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_root", lambda: tmp_path / "_build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.lib()
    with pytest.raises(RuntimeError):
        tstruct.symbolic_factor(*_chain(10), 3, "amd")
    assert not list((tmp_path / "_build").glob("*/" + native.LIB_NAME))


def test_failing_compile_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "build_root", lambda: tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()


def test_fresh_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_root", lambda: tmp_path / "_build")
    path = native.build()
    assert path.exists() and path.parent.name == native.source_hash() and native.build_seconds > 0
    assert native.build() == path  # reused
    n, pairs = _chain(20)
    assert native.native_symbolic(n, pairs, "amd")[0].tolist() == tstruct.amd_ordering(n, pairs).tolist()
    with pytest.raises(ValueError):
        native.native_symbolic(n, pairs, "rcm")
