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
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
SOURCES = ("between_se3.cu", "assemble_blocks.cu", "level_factor.cu", "level_subst.cu")
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
KERNELS = ("between_se3", "assemble_blocks", "level_factor", "level_fwd_subst", "level_bwd_subst")
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
    # v1, v2, meas, meas_k_stride, meas_b_stride, K, B, eps x3, j1, j2, err, stream
    "th_between_se3": [_P, _P, _P, _L, _L, _I, _I, _D, _D, _D, _P, _P, _P, _P],
    # jac ptrs, err ptrs, m (host arrays), n_src, ata rowptr, ata items,
    # n_slots, atb rowptr, atb items, n_vars, B, d, ata, atb, stream
    "th_assemble_blocks": [
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_I), _I,
        _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
    ],
    # col_a, ks, kj, C, rl, ul, B, d, out, stream
    "th_level_factor": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # ljk, yk, b, ldiag, C, ul, B, d, y, stream
    "th_level_fwd_subst": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # lcol, xr, y, C, rl, B, d, x, stream
    "th_level_bwd_subst": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
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
