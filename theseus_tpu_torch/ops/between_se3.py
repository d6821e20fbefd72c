"""Fused SE3 Between linearization: CUDA kernel and plain twin (JAX counterpart: theseus_tpu/ops/pallas_between_soa.py).

`between_linearize(v1, v2, meas)` computes, per edge k and batch element b,
d = v1^{-1} v2, r = log(m^{-1} d), J2 = jlog(m^{-1} d) and
J1 = -J2 Adj(d^{-1}). On a CUDA tensor it launches `csrc/between_se3.cu`;
on a CPU tensor it runs `between_linearize_plain`, the pure-torch
formulation of the same outputs (the model of the JAX package's
`_reference_linearize`). While autograd records, the call goes through
`twin_vjp`'s Function, whose backward differentiates that twin.

`between_linearize_fused` is the AoS entry point of the JAX package's
`ops/pallas_between.py`, which computes the same function on the same
(K, B, 3, 4) layout: it launches the same kernel.

The kernel's launch (block size, shared memory) is worked out here, in
`between_geometry`, where the CPU tests reach it.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..config import get_eps, use_kernel
from ..lie import se3
from .twin_vjp import kernel_with_twin_vjp

# the shared-memory values a thread's outputs occupy in csrc/between_se3.cu
# (BT_TILE: J1 and J2 rows padded from 36 to 37 values, err from 6 to 7)
BETWEEN_TILE = 2 * 37 + 7


def between_geometry(n: int, itemsize: int, min_blocks: int):
    """(threads, blocks, shared-memory bytes) of one `between_se3` launch
    over n = K B items: `_cuda.tile_geometry` with the Between tile."""
    return _cuda.tile_geometry(n, itemsize, min_blocks, BETWEEN_TILE)


def between_linearize_plain(v1, v2, meas):
    """(K, B, 3, 4) x3 -> (j1, j2 (K, B, 6, 6), err (K, B, 6))."""
    diff = se3.compose(se3.inverse(v1), v2)
    (jl,), res = se3.jlog(se3.compose(se3.inverse(meas), diff))
    j1 = -(jl @ se3.adjoint(se3.inverse(diff)))
    return j1, jl, res


def _forward(counter):
    """The outputs without autograd: the kernel on a CUDA tensor (its launch
    counted under `counter`), the twin on a CPU tensor."""

    def fwd(v1, v2, meas):
        if not use_kernel(v1):
            return between_linearize_plain(v1, v2, meas)
        return _launch(v1, v2, meas, counter)

    return fwd


def between_linearize(v1, v2, meas):
    """v1, v2 (K, B, 3, 4); meas broadcastable to them (a shared measurement
    may drop the edge axis). Returns (j1, j2, err)."""
    return kernel_with_twin_vjp(_forward("between_se3"), between_linearize_plain, v1, v2, meas.expand(v1.shape))


def between_linearize_fused(v1, v2, meas, block_edges: int = 8):
    """The AoS entry point of the JAX package's ops/pallas_between.py
    (pallas_call :60): v1, v2, meas (K, B, 3, 4) -> (j1, j2 (K, B, 6, 6),
    err (K, B, 6)). The same function as `between_linearize`, on the same
    kernel, counted under its own name. Any K is accepted; `block_edges`,
    the TPU kernel's edge tiling, is validated and has no other effect."""
    if int(block_edges) < 1:
        raise ValueError(f"block_edges must be positive, got {block_edges}")
    if meas.shape != v1.shape:
        raise ValueError(f"between_linearize_fused expects meas of shape {tuple(v1.shape)}, "
                         f"got {tuple(meas.shape)}")
    return kernel_with_twin_vjp(_forward("between_se3_aos"), between_linearize_plain, v1, v2, meas)


def _launch(v1, v2, meas, counter):
    if v1.dim() != 4 or tuple(v1.shape[2:]) != (3, 4) or v2.shape != v1.shape:
        raise ValueError(f"between_linearize expects (K, B, 3, 4) poses, got {v1.shape}, {v2.shape}")
    if not (v1.device == v2.device == meas.device) or not (v1.dtype == v2.dtype == meas.dtype):
        raise ValueError("between_linearize operands must share device and dtype")
    fn = getattr(_cuda.lib(), f"th_between_se3_{_cuda.suffix(v1.dtype)}")
    v1 = v1.contiguous()
    v2 = v2.contiguous()
    if meas.stride(-1) != 1 or meas.stride(-2) != 4:
        meas = meas.contiguous()
    k, b = v1.shape[0], v1.shape[1]
    threads, _, smem = between_geometry(k * b, v1.element_size(), _cuda.tile_min_blocks(v1.device.index))
    j1 = torch.empty((k, b, 6, 6), dtype=v1.dtype, device=v1.device)
    j2 = torch.empty_like(j1)
    err = torch.empty((k, b, 6), dtype=v1.dtype, device=v1.device)
    dt = v1.dtype
    with torch.cuda.device(v1.device):
        rc = fn(
            v1.data_ptr(), v2.data_ptr(), meas.data_ptr(), meas.stride(0), meas.stride(1),
            k, b,
            get_eps("so3", "near_zero", dt), get_eps("so3", "near_pi", dt),
            get_eps("so3", "d_near_zero", dt), threads, smem,
            j1.data_ptr(), j2.data_ptr(), err.data_ptr(), _cuda.stream_of(v1),
        )
    _cuda.check(rc, counter)
    _cuda.launches[counter] += 1
    return j1, j2, err
