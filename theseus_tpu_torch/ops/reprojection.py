"""Fused Reprojection linearization: CUDA kernel and plain twin (JAX counterpart: theseus_tpu/ops/pallas_reprojection.py).

Per observation k and batch element b:

    P = R p + t;  proj = -P_xy / P_z;  r2 = |proj|^2
    factor = f (1 + r2 (k1 + r2 k2));  err = proj * factor - feat

with closed-form jacobians jpt = de/dP R (2x3) and
jpose = [jpt | -jpt hat(p)] (2x6, right tangent [lin; ang]).
`reprojection_linearize` launches `csrc/reprojection.cu` on a CUDA tensor
and runs `reprojection_linearize_plain` (the port of the JAX package's
`_reference_linearize`) on a CPU tensor. While autograd records, the call
goes through `twin_vjp`'s Function, whose forward is that same launch
or twin and whose backward is the VJP of the twin at the saved inputs (the
JAX package's `_fused_bwd` takes `jax.vjp` of `_reference_linearize`; it
has no backward kernel either). The kernel's launch (block size, shared
memory) is worked out here, in `reprojection_geometry`, where the CPU tests
reach it.
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..config import use_kernel
from ..lie.utils import so3_hat
from .twin_vjp import kernel_with_twin_vjp

# the shared-memory values a thread's outputs occupy in csrc/reprojection.cu
# (RP_TILE: jpose's row padded from 12 to 13 values, jpt's from 6 to 7,
# err's from 2 to 3)
REPROJECTION_TILE = 13 + 7 + 3


def reprojection_geometry(n: int, itemsize: int, min_blocks: int):
    """(threads, blocks, shared-memory bytes) of one `reprojection` launch
    over n = K B items: `_cuda.tile_geometry` with the Reprojection tile."""
    return _cuda.tile_geometry(n, itemsize, min_blocks, REPROJECTION_TILE)


def reprojection_linearize_plain(pose, point, focal, feat, k1, k2):
    """pose (..., 3, 4), point (..., 3), focal/k1/k2 (..., 1), feat (..., 2)
    -> (jpose (..., 2, 6), jpt (..., 2, 3), err (..., 2))."""
    r = pose[..., :3]
    p_cam = torch.einsum("...ij,...j->...i", r, point) + pose[..., 3]
    px, py, pz = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    proj = -p_cam[..., :2] / pz[..., None]
    r2 = torch.sum(proj * proj, dim=-1)
    f = focal[..., 0]
    k1s, k2s = k1[..., 0], k2[..., 0]
    factor = f * (1.0 + r2 * (k1s + r2 * k2s))
    err = proj * factor[..., None] - feat

    dfdr2 = f * (k1s + 2.0 * r2 * k2s)
    eye2 = torch.eye(2, dtype=pose.dtype, device=pose.device)
    de_dproj = factor[..., None, None] * eye2 + 2.0 * dfdr2[..., None, None] * (
        proj[..., :, None] * proj[..., None, :]
    )
    inv_z = 1.0 / pz
    zeros = torch.zeros_like(px)
    dproj_dp = torch.stack(
        [
            torch.stack([-inv_z, zeros, px * inv_z * inv_z], dim=-1),
            torch.stack([zeros, -inv_z, py * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )
    de_dp = de_dproj @ dproj_dp  # (..., 2, 3)
    jpt = de_dp @ r
    jpose = torch.cat([jpt, -jpt @ so3_hat(point)], dim=-1)
    return jpose, jpt, err


def broadcast_aux(pose, aux):
    """Shared aux (B, s) -> (K, B, s) views with a zero K stride; stacked
    (K, B, s) aux pass through."""
    return [a.expand(pose.shape[:1] + a.shape) if a.dim() == pose.dim() - 2 else a for a in aux]


def _forward(*ops):
    """The outputs without autograd: the kernel on a CUDA tensor, the twin
    on a CPU tensor."""
    if not use_kernel(ops[0]):
        return reprojection_linearize_plain(*ops)
    return _launch(*ops)


def reprojection_linearize(pose, point, focal, feat, k1, k2):
    """pose (K, B, 3, 4), point (K, B, 3); focal, k1, k2 (K, B, 1) and feat
    (K, B, 2), each of them or shared (B, s). Returns (jpose, jpt, err)."""
    return kernel_with_twin_vjp(_forward, reprojection_linearize_plain, pose, point,
                                *broadcast_aux(pose, (focal, feat, k1, k2)))


def _launch(pose, point, focal, feat, k1, k2):
    if pose.dim() != 4 or tuple(pose.shape[2:]) != (3, 4):
        raise ValueError(f"reprojection_linearize expects (K, B, 3, 4) poses, got {tuple(pose.shape)}")
    k, b = pose.shape[0], pose.shape[1]
    if tuple(point.shape) != (k, b, 3):
        raise ValueError(f"reprojection_linearize: points {tuple(point.shape)} != {(k, b, 3)}")
    aux = (focal, feat, k1, k2)
    for a, s in zip(aux, (1, 2, 1, 1)):
        if tuple(a.shape) != (k, b, s):
            raise ValueError(f"reprojection_linearize: aux {tuple(a.shape)} != {(k, b, s)}")
    ops = (pose, point) + aux
    if any(t.device != pose.device or t.dtype != pose.dtype for t in ops):
        raise ValueError("reprojection_linearize operands must share device and dtype")
    # the kernel indexes in 64 bits, but 2^31 or more items is far beyond
    # any problem that fits on the card
    if k * b >= 2**31:
        raise ValueError(f"reprojection_linearize: K*B = {k * b} items exceed the kernel's grid")
    fn = getattr(_cuda.lib(), f"th_reprojection_{_cuda.suffix(pose.dtype)}")
    threads, _, smem = reprojection_geometry(k * b, pose.element_size(), _cuda.tile_min_blocks(pose.device.index))
    pose = pose.contiguous()
    point = point.contiguous()
    # aux is read through (k, b) element strides: a shared slot keeps its
    # zero k stride; only its innermost axis must be dense
    aux = tuple(a if a.stride(-1) == 1 else a.contiguous() for a in aux)
    jpose = torch.empty((k, b, 2, 6), dtype=pose.dtype, device=pose.device)
    jpt = torch.empty((k, b, 2, 3), dtype=pose.dtype, device=pose.device)
    err = torch.empty((k, b, 2), dtype=pose.dtype, device=pose.device)
    strides = [s for a in aux for s in (a.stride(0), a.stride(1))]
    with torch.cuda.device(pose.device):
        rc = fn(
            pose.data_ptr(), point.data_ptr(), *(a.data_ptr() for a in aux), *strides,
            k, b, threads, smem, jpose.data_ptr(), jpt.data_ptr(), err.data_ptr(), _cuda.stream_of(pose),
        )
    _cuda.check(rc, "reprojection")
    _cuda.launches["reprojection"] += 1
    return jpose, jpt, err
