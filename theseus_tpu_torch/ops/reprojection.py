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

With the camera's intrinsics (f, k1, k2) optimised (BAL's 9-parameter
camera), `reprojection_intr_linearize` takes them as a third gathered stack
(K, B, 3) and also returns their jacobian jintr (2x3):

    de/df = proj (1 + r2 (k1 + r2 k2));  de/dk1 = f r2 proj;  de/dk2 = f r2^2 proj

from `reprojection_intr_kernel` in the same file on the card and from
`reprojection_intr_linearize_plain` on the CPU, with the same autograd.
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
# the intrinsics variant's (RP_TILE_INTR): jintr's row of 6 padded to 7
REPROJECTION_INTR_TILE = 13 + 7 + 7 + 3


def reprojection_geometry(n: int, itemsize: int, min_blocks: int, tile: int = REPROJECTION_TILE):
    """(threads, blocks, shared-memory bytes) of one `reprojection` launch
    over n = K B items: `_cuda.tile_geometry` with the Reprojection tile
    (REPROJECTION_INTR_TILE for the intrinsics variant)."""
    return _cuda.tile_geometry(n, itemsize, min_blocks, tile)


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


def reprojection_intr_linearize_plain(pose, point, intr, feat):
    """pose (..., 3, 4), point (..., 3), intr (..., 3) = (f, k1, k2), feat
    (..., 2) -> (jpose (..., 2, 6), jpt (..., 2, 3), jintr (..., 2, 3),
    err (..., 2))."""
    f, k1, k2 = intr[..., 0:1], intr[..., 1:2], intr[..., 2:3]
    jpose, jpt, err = reprojection_linearize_plain(pose, point, f, feat, k1, k2)
    p_cam = torch.einsum("...ij,...j->...i", pose[..., :3], point) + pose[..., 3]
    proj = -p_cam[..., :2] / p_cam[..., 2:3]
    r2 = torch.sum(proj * proj, dim=-1)[..., None]
    sc = 1.0 + r2 * (k1 + r2 * k2)
    fr2 = f * r2
    jintr = torch.stack([proj * sc, fr2 * proj, (fr2 * r2) * proj], dim=-1)
    return jpose, jpt, jintr, err


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


def _forward_intr(*ops):
    if not use_kernel(ops[0]):
        return reprojection_intr_linearize_plain(*ops)
    return _launch_intr(*ops)


def reprojection_intr_linearize(pose, point, intr, feat):
    """pose (K, B, 3, 4), point (K, B, 3), intr (K, B, 3); feat (K, B, 2)
    or shared (B, 2). Returns (jpose, jpt, jintr, err)."""
    return kernel_with_twin_vjp(_forward_intr, reprojection_intr_linearize_plain, pose, point, intr,
                                *broadcast_aux(pose, (feat,)))


def _check_operands(name, pose, point, stacks, aux, sizes):
    """Shapes (K, B, ...), one device and dtype, and a grid that fits."""
    if pose.dim() != 4 or tuple(pose.shape[2:]) != (3, 4):
        raise ValueError(f"{name} expects (K, B, 3, 4) poses, got {tuple(pose.shape)}")
    k, b = pose.shape[0], pose.shape[1]
    for t in (point,) + stacks:
        if tuple(t.shape) != (k, b, 3):
            raise ValueError(f"{name}: {tuple(t.shape)} != {(k, b, 3)}")
    for a, s in zip(aux, sizes):
        if tuple(a.shape) != (k, b, s):
            raise ValueError(f"{name}: aux {tuple(a.shape)} != {(k, b, s)}")
    if any(t.device != pose.device or t.dtype != pose.dtype for t in (point,) + stacks + tuple(aux)):
        raise ValueError(f"{name} operands must share device and dtype")
    # the kernel indexes in 64 bits, but 2^31 or more items is far beyond
    # any problem that fits on the card
    if k * b >= 2**31:
        raise ValueError(f"{name}: K*B = {k * b} items exceed the kernel's grid")
    return k, b


def _launch_intr(pose, point, intr, feat):
    k, b = _check_operands("reprojection_intr_linearize", pose, point, (intr,), (feat,), (2,))
    fn = getattr(_cuda.lib(), f"th_reprojection_intr_{_cuda.suffix(pose.dtype)}")
    threads, _, smem = reprojection_geometry(k * b, pose.element_size(), _cuda.tile_min_blocks(pose.device.index),
                                             REPROJECTION_INTR_TILE)
    pose, point, intr = pose.contiguous(), point.contiguous(), intr.contiguous()
    feat = feat if feat.stride(-1) == 1 else feat.contiguous()
    jpose = torch.empty((k, b, 2, 6), dtype=pose.dtype, device=pose.device)
    jpt = torch.empty((k, b, 2, 3), dtype=pose.dtype, device=pose.device)
    jintr = torch.empty((k, b, 2, 3), dtype=pose.dtype, device=pose.device)
    err = torch.empty((k, b, 2), dtype=pose.dtype, device=pose.device)
    with torch.cuda.device(pose.device):
        rc = fn(pose.data_ptr(), point.data_ptr(), intr.data_ptr(), feat.data_ptr(), feat.stride(0), feat.stride(1),
                k, b, threads, smem, jpose.data_ptr(), jpt.data_ptr(), jintr.data_ptr(), err.data_ptr(),
                _cuda.stream_of(pose))
    _cuda.check(rc, "reprojection_intr")
    _cuda.launches["reprojection_intr"] += 1
    return jpose, jpt, jintr, err


def _launch(pose, point, focal, feat, k1, k2):
    aux = (focal, feat, k1, k2)
    k, b = _check_operands("reprojection_linearize", pose, point, (), aux, (1, 2, 1, 1))
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
