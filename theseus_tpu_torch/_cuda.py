"""Build and load the port's CUDA kernel library (JAX counterpart: none; Pallas compiled its kernels while tracing).

The sources under `csrc/` are compiled with `nvcc` for Hopper
(`sm_90a`) into one shared library with a plain C interface, loaded with
`ctypes`. The build happens at first use, never at import, into
`_build/<hash>/` next to this file; the hash covers the sources and the
flags, so an edited kernel rebuilds and an unchanged one is reused. The
build writes to a private directory and renames it into place, so
concurrent processes cannot load a half-written library.

Nothing here falls back: a missing `nvcc` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
SOURCES = (
    "between_se3.cu", "assemble_blocks.cu", "level_factor.cu", "level_subst.cu", "reprojection.cu",
    "whole_factor.cu", "whole_subst.cu", "tail_update.cu",
)
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libtheseus_tpu_torch.so"

_lib: Optional[ctypes.CDLL] = None
# seconds the last build() took in this process (0.0 when the cached library
# was reused, None before the first build)
build_seconds: Optional[float] = None

# Launch counts, one per kernel: each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show that it went through them.
KERNELS = (
    "between_se3", "assemble_blocks", "level_factor", "level_fwd_subst", "level_bwd_subst",
    "reprojection", "whole_factor", "whole_fwd_subst", "whole_bwd_subst", "between_se3_aos", "tail_update",
    "reprojection_intr",
)
launches = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def build_root() -> Path:
    return _HERE / "_build"


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def build() -> Path:
    """Compile the library if no build for the current sources exists.
    Returns the library path; the compiler's -Xptxas -v report is kept in
    `build.log` beside it."""
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
    nvcc = _nvcc()
    # one nvcc process per source, in parallel, then one link
    procs = []
    for name in SOURCES:
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log = []
    failed = []
    for name, p in procs:
        out, _ = p.communicate()
        log.append(f"==== {name} (rc={p.returncode})\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            failed.append(name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}; log:\n" + "\n".join(log))
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME)]
    link += [str(tmp / (Path(n).stem + ".o")) for n in SOURCES]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout.decode(errors="replace"))
    try:
        os.replace(tmp, final)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def build_log() -> str:
    path = build_root() / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    # v1, v2, meas, meas_k_stride, meas_b_stride, K, B, eps x3, threads,
    # shared-memory bytes (ops/between_se3.py between_geometry), j1, j2,
    # err, stream
    "th_between_se3": [_P, _P, _P, _L, _L, _I, _I, _D, _D, _D, _I, _L, _P, _P, _P, _P],
    # jac ptrs, err ptrs, m (host arrays), n_src, ata rowptr, ata items,
    # atb rowptr, atb items, split rows, n_split, n_large, tile, threads,
    # short ata slots, n, short atb rows, n, B, d, vec (jacobians 16-byte
    # aligned), ata, atb, stream
    "th_assemble_blocks": [
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
    ],
    # col_a, ks, kj, C, rl, ul, B, d, out, stream
    "th_level_factor": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # ljk, yk, b, ldiag, C, ul, B, d, batch tile, lanes per output, u
    # chunk (sparse/level_kernels.py fwd_subst_geometry), y, stream
    "th_level_fwd_subst": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # lcol, xr, y, C, rl, B, d, batch tile, rows a chunk
    # (sparse/level_kernels.py bwd_subst_geometry), x, stream
    "th_level_bwd_subst": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # pose, point, focal, feat, k1, k2, (k, b) strides of the four aux,
    # K, B, threads, shared-memory bytes (ops/reprojection.py
    # reprojection_geometry), jpose, jpt, err, stream
    "th_reprojection": [_P] * 6 + [_L] * 8 + [_I, _I, _I, _L, _P, _P, _P, _P],
    # pose, point, intrinsics, feat, feat's (k, b) strides, K, B, threads,
    # shared-memory bytes (reprojection_geometry with REPROJECTION_INTR_TILE),
    # jpose, jpt, jintr, err, stream
    "th_reprojection_intr": [_P] * 4 + [_L] * 2 + [_I, _I, _I, _L] + [_P] * 5,
    # ata, level records, lvl (n_levels, 4), n_levels, factor slots, largest
    # record's ints, shared-memory bytes (0: the factor in device memory), B,
    # d, lflat, stream
    "th_whole_factor": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _P, _P],
    # lflat, b (y), stage records, stage table (n_stages, 4), n_stages, the
    # largest record's ints, values a stage buffer holds, n, B, d, y (x) in
    # shared memory (0 / 1), shared-memory bytes, y (x), stream
    # (sparse/whole.py FwdPlan, BwdPlan)
    "th_whole_fwd_subst": [_P] * 4 + [_I] * 7 + [_L, _P, _P],
    "th_whole_bwd_subst": [_P] * 4 + [_I] * 7 + [_L, _P, _P],
    # ata, lflat, output table, pair pointers, pairs (sparse/cholesky.py
    # NumericSchedule.tail_on), outputs, K, B, d, dense, stream
    "th_tail_update": [_P] * 5 + [_I] * 4 + [_P, _P],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for base, argtypes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(handle, f"{base}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        handle.th_error_string.argtypes = [ctypes.c_int]
        handle.th_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def suffix(dtype) -> str:
    """Kernel-name suffix for a torch dtype; other dtypes raise."""
    import torch

    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the CUDA kernels take float32 or float64 tensors, got {dtype}")


def check(rc: int, name: str) -> None:
    """Raise if a launch reported an error (cudaGetLastError after it)."""
    if rc != 0:
        msg = lib().th_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The streaming multiprocessors of a card, read once a card (a launch's
    geometry asks on every call of a host-bound loop)."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


# tile_geometry: the block sizes of the kernels that give a block a
# contiguous range of items (csrc/between_se3.cu, csrc/reprojection.cu)
TILE_THREADS_MIN = 64
TILE_THREADS_MAX = 256
TILE_BLOCKS_PER_SM = 2  # the block shrinks until the launch has this many blocks per SM


@functools.lru_cache(maxsize=1024)
def tile_geometry(n: int, itemsize: int, min_blocks: int, tile: int):
    """(threads, blocks, shared-memory bytes) of a launch over n items, a
    block per contiguous range of `threads` items and `tile` values of
    itemsize bytes a thread in shared memory. threads starts at
    TILE_THREADS_MAX and halves, down to TILE_THREADS_MIN, while the launch
    would have fewer than min_blocks blocks (TILE_BLOCKS_PER_SM times the
    card's SMs). Cached: the LM loop asks again for the same shapes every
    iteration."""
    threads = TILE_THREADS_MAX
    while threads > TILE_THREADS_MIN and -(-n // threads) < min_blocks:
        threads //= 2
    return threads, -(-n // threads), tile * threads * itemsize


def tile_min_blocks(device_index: int) -> int:
    """tile_geometry's min_blocks on a card: TILE_BLOCKS_PER_SM times its SMs."""
    return TILE_BLOCKS_PER_SM * sm_count(device_index)
