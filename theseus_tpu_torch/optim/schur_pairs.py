"""The Schur pair sum into S: its pair table, CUDA kernel and plain twin (JAX counterpart: the chunked `lax.scan` of theseus_tpu/optim/schur.py, jnp).

S -= sum over the points p of W_a,p H_b,p^T for every pair of cameras (a, b)
that see p, where W = Hcp Hpp^-1 and Hcp are the (camera, point) coupling
blocks, (O, B, dc, dp). The pairs come from `pair_table`: one CSR segment
per camera pair that shares a point, with one (W's coupling, Hcp's
coupling) entry per shared point, so the sum forms the useful products
only, sum over points of k^2 for a point seen by k cameras
(`SchurNormalBuilder.pair_counts()`).

- `schur_pairs(s, w, hcp, t)` launches `csrc/schur_pairs.cu` on a CUDA
  tensor and runs `schur_pairs_plain` on a CPU one; S is updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _cuda
from ..config import use_kernel
from ..ops.batched_linalg import SMALL_DIM_MAX

# entries the plain twin gathers and multiplies at a time
PLAIN_ENTRIES = 1 << 18
DC_MAX = 32  # the kernel's dc * dc threads a block


def pair_table(cp_cam, cp_pt, n_cams: int):
    """The camera pairs of the couplings (cp_cam[o], cp_pt[o]), as int32
    numpy arrays:
    - obs (n, 2): (coupling of camera a, coupling of camera b) of each
      point both see, ordered by (a, b), then by point; a = b included;
    - ptr (n_seg + 1): each pair's segment of obs;
    - blk (n_seg, 2): its (a, b);
    - order (n_seg): the segments longest first, the kernel's launch order.
    n is the sum over points of k^2, k the point's cameras."""
    cp_cam, cp_pt = np.asarray(cp_cam, np.int32), np.asarray(cp_pt, np.int32)
    k = np.bincount(cp_pt).astype(np.int32)
    by_pt = np.argsort(cp_pt, kind="stable").astype(np.int32)
    # each coupling ob in (camera, point) order, paired with every coupling
    # oa of its point: the entries in (b, point) order; one stable sort by a
    # then orders them by (a, b, point)
    by_cam = np.lexsort((cp_pt, cp_cam)).astype(np.int32)
    reps = k[cp_pt[by_cam]]
    n = int(reps.sum())
    obs = np.empty((n, 2), np.int32)
    obs[:, 1] = np.repeat(by_cam, reps)
    first = (np.cumsum(k) - k)[cp_pt[by_cam]] - (np.cumsum(reps) - reps)  # by_pt's index of ob's point, less ob's
    obs[:, 0] = by_pt[np.repeat(first.astype(np.int32), reps) + np.arange(n, dtype=np.int32)]
    cam_a = cp_cam[obs[:, 0]]
    order = np.argsort(cam_a.astype(np.min_scalar_type(max(0, n_cams - 1))), kind="stable")
    obs = obs.view(np.int64).reshape(-1)[order].view(np.int32).reshape(n, 2)  # one 8-byte gather a row
    key = np.repeat(np.arange(n_cams, dtype=np.int64) * n_cams, np.bincount(cam_a, minlength=n_cams))
    key += cp_cam[obs[:, 1]]
    starts = np.flatnonzero(np.diff(key, prepend=-1))
    ptr = np.append(starts, n)
    return {
        "obs": obs,
        "ptr": ptr.astype(np.int32),
        "blk": np.stack([key[starts] // n_cams, key[starts] % n_cams], 1).astype(np.int32),
        "order": np.argsort(-np.diff(ptr), kind="stable").astype(np.int32),
    }


def schur_pairs_plain(s, w, hcp, t):
    """S (B, C dc, C dc) -= the pair sum of w and hcp (O, B, dc, dp) over
    the table t (`pair_table` as tensors on s's device), in place; returns
    s. PLAIN_ENTRIES entries at a time: their blocks gathered, multiplied
    and `index_add_`ed into their segments' blocks."""
    bsz, dc = s.shape[0], w.shape[2]
    n_cams = s.shape[-1] // dc
    ptr, obs = t["ptr"].long(), t["obs"].long()
    acc = torch.zeros((t["blk"].shape[0], bsz, dc, dc), dtype=s.dtype, device=s.device)
    for lo in range(0, obs.shape[0], PLAIN_ENTRIES):
        hi = min(obs.shape[0], lo + PLAIN_ENTRIES)
        seg = torch.searchsorted(ptr, torch.arange(lo, hi, device=s.device), right=True) - 1
        acc.index_add_(0, seg, torch.einsum("nbij,nbmj->nbim", w[obs[lo:hi, 0]], hcp[obs[lo:hi, 1]]))
    a, b = t["blk"][:, 0].long(), t["blk"][:, 1].long()
    s5 = s.view(bsz, n_cams, dc, n_cams, dc)
    s5[:, a, :, b] -= acc  # each (a, b) once
    return s


def schur_pairs(s, w, hcp, t):
    """`schur_pairs_plain` on a CPU tensor, the `schur_pairs` kernel on a
    CUDA one (one launch): S (B, C dc, C dc), contiguous, updated in place;
    returns s."""
    if not use_kernel(s):
        return schur_pairs_plain(s, w, hcp, t)
    bsz, cd = s.shape[0], s.shape[-1]
    o, dc, dp = w.shape[0], w.shape[2], w.shape[3]
    if s.shape != (bsz, cd, cd) or cd % dc or w.shape != (o, bsz, dc, dp) or hcp.shape != w.shape:
        raise ValueError(f"schur_pairs: shapes {s.shape}, {w.shape}, {hcp.shape} do not agree")
    if not 1 <= dc <= DC_MAX or not 1 <= dp <= SMALL_DIM_MAX:
        raise ValueError(f"schur_pairs: the CUDA kernel takes dc <= {DC_MAX} and dp <= {SMALL_DIM_MAX}, "
                         f"got {dc}, {dp}")
    if not s.is_contiguous():
        raise ValueError("schur_pairs: S is updated in place and must be contiguous")
    for x in (w, hcp, *t.values()):
        if x.device != s.device:
            raise ValueError("schur_pairs: operands must share S's device")
    if w.dtype != s.dtype or hcp.dtype != s.dtype:
        raise ValueError("schur_pairs: w, hcp and S must share a dtype")
    fn = getattr(_cuda.lib(), f"th_schur_pairs_{_cuda.suffix(s.dtype)}")
    w, hcp = w.contiguous(), hcp.contiguous()
    with torch.cuda.device(s.device):
        rc = fn(w.data_ptr(), hcp.data_ptr(), t["ptr"].data_ptr(), t["blk"].data_ptr(), t["obs"].data_ptr(),
                t["order"].data_ptr(), t["blk"].shape[0], cd // dc, bsz, dc, dp, s.data_ptr(),
                _cuda.stream_of(s))
    _cuda.check(rc, "schur_pairs")
    _cuda.launches["schur_pairs"] += 1
    return s
