"""Native (C++) symbolic analysis, built with g++ and loaded with ctypes (JAX counterpart: theseus_tpu/native/__init__.py).

`symbolic.cpp` (a copy of the JAX package's) computes a fill-reducing
ordering ("natural", "amd" or "nd"), the elimination pattern and the
elimination tree of a block graph. `sparse/structure.py` `symbolic_factor`
takes this path for those orderings; its pure-Python analysis is the twin
the tests hold it against.

The build follows `_cuda.py`: `g++ -O2 -shared -fPIC -std=c++17` at first
use, never at import, into `_build/<hash>/` beside the package (the hash
covers the source and the flags), written to a private directory and
renamed into place so that concurrent processes never load a half-written
library. A failed build raises with the compiler's output: unlike the JAX
package, nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "symbolic.cpp"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libtheseus_symbolic.so"
MODES = {"natural": 0, "amd": 1, "nd": 2}

_lib: Optional[ctypes.CDLL] = None
# seconds the last build() took in this process (0.0 when the cached
# library was reused, None before the first build)
build_seconds: Optional[float] = None


def build_root() -> Path:
    return _HERE.parent / "_build"


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return "symbolic-" + h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless a build of the current source exists;
    returns its path. Raises RuntimeError with the compiler's output when
    the compiler is missing or fails."""
    global build_seconds
    final = build_root() / source_hash()
    lib_path = final / LIB_NAME
    if lib_path.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return lib_path
    t0 = time.perf_counter()
    build_root().mkdir(parents=True, exist_ok=True)
    tmp = build_root() / f"{final.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp / LIB_NAME)]
    try:
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600)
    except OSError as e:  # the compiler itself is missing
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"cannot run {CXX} to build the native symbolic analysis: {e}") from e
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (rc={res.returncode}):\n" + res.stdout.decode(errors="replace"))
    try:
        os.replace(tmp, final)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        arr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        handle.symbolic_analyze.restype = ctypes.c_void_p
        handle.symbolic_analyze.argtypes = [i64, i64, arr, i64]
        handle.symbolic_nnz.restype = i64
        handle.symbolic_nnz.argtypes = [ctypes.c_void_p]
        handle.symbolic_fetch.restype = None
        handle.symbolic_fetch.argtypes = [ctypes.c_void_p, arr, arr, arr, arr, arr]
        handle.symbolic_free.restype = None
        handle.symbolic_free.argtypes = [ctypes.c_void_p]
        _lib = handle
    return _lib


def native_symbolic(n: int, pairs, ordering: str) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray, np.ndarray]:
    """(perm, rows of every column (diagonal first, sorted), etree parent,
    etree level) of the block graph on n variables with undirected edges
    `pairs`, under `ordering` ("natural", "amd" or "nd")."""
    if ordering not in MODES:
        raise ValueError(f"the native symbolic analysis takes {sorted(MODES)}, got {ordering!r}")
    edges = np.ascontiguousarray(np.array(sorted(pairs), dtype=np.int64).reshape(-1))
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    handle_lib = lib()
    handle = handle_lib.symbolic_analyze(n, len(edges) // 2, edges, MODES[ordering])
    if not handle:
        raise RuntimeError(f"native symbolic analysis failed (n={n}, ordering={ordering})")
    try:
        nnz = handle_lib.symbolic_nnz(handle)
        perm = np.empty(n, np.int64)
        col_ptr = np.empty(n + 1, np.int64)
        col_rows = np.empty(nnz, np.int64)
        etree = np.empty(n, np.int64)
        level_of = np.empty(n, np.int64)
        handle_lib.symbolic_fetch(handle, perm, col_ptr, col_rows, etree, level_of)
    finally:
        handle_lib.symbolic_free(handle)
    return perm, [col_rows[col_ptr[j]:col_ptr[j + 1]] for j in range(n)], etree, level_of
