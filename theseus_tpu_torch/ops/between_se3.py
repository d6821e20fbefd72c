"""Fused SE3 Between linearization: CUDA kernel and plain twin (JAX counterpart: theseus_tpu/ops/pallas_between_soa.py).

`between_linearize(v1, v2, meas)` computes, per edge k and batch element b,
d = v1^{-1} v2, r = log(m^{-1} d), J2 = jlog(m^{-1} d) and
J1 = -J2 Adj(d^{-1}). On a CUDA tensor it launches `csrc/between_se3.cu`;
on a CPU tensor it runs `between_linearize_plain`, the pure-torch
formulation of the same outputs (the model of the JAX package's
`_reference_linearize`).
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..config import check_no_grad, get_eps, use_kernel
from ..lie import se3


def between_linearize_plain(v1, v2, meas):
    """(K, B, 3, 4) x3 -> (j1, j2 (K, B, 6, 6), err (K, B, 6))."""
    diff = se3.compose(se3.inverse(v1), v2)
    (jl,), res = se3.jlog(se3.compose(se3.inverse(meas), diff))
    j1 = -(jl @ se3.adjoint(se3.inverse(diff)))
    return j1, jl, res


def between_linearize(v1, v2, meas):
    """v1, v2 (K, B, 3, 4); meas broadcastable to them (a shared measurement
    may drop the edge axis). Returns (j1, j2, err)."""
    check_no_grad(v1, v2, meas)
    meas = meas.expand(v1.shape)
    if not use_kernel(v1):
        return between_linearize_plain(v1, v2, meas)
    return _launch(v1, v2, meas)


def _launch(v1, v2, meas):
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
    j1 = torch.empty((k, b, 6, 6), dtype=v1.dtype, device=v1.device)
    j2 = torch.empty_like(j1)
    err = torch.empty((k, b, 6), dtype=v1.dtype, device=v1.device)
    dt = v1.dtype
    with torch.cuda.device(v1.device):
        rc = fn(
            v1.data_ptr(), v2.data_ptr(), meas.data_ptr(), meas.stride(0), meas.stride(1),
            k, b,
            get_eps("so3", "near_zero", dt), get_eps("so3", "near_pi", dt),
            get_eps("so3", "d_near_zero", dt),
            j1.data_ptr(), j2.data_ptr(), err.data_ptr(), _cuda.stream_of(v1),
        )
    _cuda.check(rc, "between_se3")
    _cuda.launches["between_se3"] += 1
    return j1, j2, err
