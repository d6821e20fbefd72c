"""Bundle-adjustment problems: synthetic generator, BAL reader and writer, objective (JAX counterpart: theseus_tpu/utils/examples/bundle_adjustment.py).

`synthetic_ba` places cameras on a ring looking at a point cloud and makes
observations from the projections plus noise, with the JAX package's
geometry and visibility rule. Its random numbers come from a numpy Generator
seeded by `seed`, not the JAX generator's stream, so the problem is
reproducible without JAX but is not the JAX package's; to solve the JAX
package's exact arrays, carry them over with utils/convert.py
(`ba_problem_from_arrays`).

`build_ba_objective` builds one Reprojection cost per observation, as one
CostFamily over a camera SE3Family and a landmark Point3Family (the default,
O(1) Python objects at any size) or as individual costs (for parity tests),
plus a Local prior on camera 0 that fixes the gauge; `robust_loss_cls`
wraps every Reprojection cost in that robust loss, its log radius the aux
variable "obs_log_radius". Solve it with `LevenbergMarquardt(obj,
linearization="schur", adaptive_damping=True, ellipsoidal_damping=True)`;
every backward mode of `TheseusLayer.forward` differentiates through it,
so an outer loop can learn the radius.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ... import core
from ...config import resolve_device
from ...embodied import Local, Reprojection
from ...lie import se3, so3


@dataclasses.dataclass
class BAProblem:
    """num_cameras cameras, num_points world points, observations linking
    them. Shapes: poses (C, B, 3, 4) world-to-camera, points (P, B, 3),
    focals, k1, k2 (C, B, 1), obs_img (O, B, 2), obs_cam / obs_pt (O,) int64
    numpy arrays."""

    poses: torch.Tensor
    points: torch.Tensor
    focals: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    obs_cam: np.ndarray
    obs_pt: np.ndarray
    obs_img: torch.Tensor
    gt_poses: Optional[torch.Tensor] = None
    gt_points: Optional[torch.Tensor] = None

    @property
    def num_cameras(self) -> int:
        return self.poses.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


def visible_pairs(num_cameras: int, num_points: int, visibility: float = 1.0):
    """(obs_cam, obs_pt): the deterministic subset of (camera, point) pairs
    each camera sees, camera-major; every point is seen by at least two
    cameras (the JAX package's rule)."""
    obs_cam = np.repeat(np.arange(num_cameras), num_points)
    obs_pt = np.tile(np.arange(num_points), num_cameras)
    if visibility >= 1.0:
        return obs_cam, obs_pt
    keep = (obs_cam + obs_pt * 7) % 100 < int(visibility * 100)
    # a point seen by fewer than two cameras gets its first two (cameras 0
    # and 1: rows pt and num_points + pt of the camera-major list)
    seen = np.bincount(obs_pt[keep], minlength=num_points)
    few = np.flatnonzero(seen < 2)
    keep[few] = True
    keep[num_points + few] = True
    return obs_cam[keep], obs_pt[keep]


def synthetic_ba(
    num_cameras: int = 8,
    num_points: int = 50,
    batch: int = 1,
    seed: int = 0,
    pixel_noise: float = 1e-3,
    pose_noise: float = 0.05,
    point_noise: float = 0.05,
    outlier_fraction: float = 0.0,
    visibility: float = 1.0,
    focal: float = 1000.0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> BAProblem:
    """Generated in float64 on the CPU from numpy's Generator(seed), then cast
    to (dtype, device); device None is the card (config.default_device)."""
    device = resolve_device(device)
    obs_cam, obs_pt = visible_pairs(num_cameras, num_points, visibility)
    rng = np.random.default_rng(seed)
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(a, dtype=f64)

    # point cloud in a box ahead of the camera ring
    points = t(rng.uniform(-1.0, 1.0, (num_points, batch, 3))) + t([0.0, 0.0, 5.0])
    # cameras on a ring, all looking roughly at the cloud's center;
    # world-to-camera pose x_cam = R (x - c), i.e. [R | -R c]
    angles = torch.linspace(-0.4, 0.4, num_cameras, dtype=f64)
    cam_pos = torch.stack([5.0 * torch.sin(angles), 0.2 * angles, 5.0 * (1 - torch.cos(angles))], -1)
    zero = torch.zeros_like(angles)
    rot = so3.exp(torch.stack([zero, -angles, zero], -1))
    trans = -torch.einsum("cij,cj->ci", rot, cam_pos)
    poses = torch.cat([rot, trans[..., None]], -1)[:, None].expand(num_cameras, batch, 3, 4)
    focals = torch.full((num_cameras, batch, 1), focal, dtype=f64)

    pc = se3.transform(poses[obs_cam], points[obs_pt])
    obs_img = -pc[..., :2] / pc[..., 2:3] * focals[obs_cam]
    obs_img = obs_img + pixel_noise * t(rng.standard_normal(obs_img.shape))
    if outlier_fraction > 0:
        out_mask = t(rng.uniform(size=(len(obs_cam), batch, 1))) < outlier_fraction
        outliers = 100.0 * t(rng.standard_normal(obs_img.shape))
        obs_img = torch.where(out_mask, obs_img + outliers, obs_img)

    noisy_poses = se3.compose(poses, se3.exp(pose_noise * t(rng.standard_normal((num_cameras, batch, 6)))))
    noisy_points = points + point_noise * t(rng.standard_normal(points.shape))
    zc = torch.zeros((num_cameras, batch, 1), dtype=f64)

    def cast(x):
        return x.to(dtype=dtype, device=device)

    return BAProblem(
        poses=cast(noisy_poses), points=cast(noisy_points), focals=cast(focals),
        k1=cast(zc), k2=cast(zc), obs_cam=obs_cam, obs_pt=obs_pt, obs_img=cast(obs_img),
        gt_poses=cast(poses), gt_points=cast(points),
    )


def load_bal(path, batch: int = 1, dtype: torch.dtype = torch.float64, device=None) -> BAProblem:
    """Bundle-Adjustment-in-the-Large text format: header
    'num_cams num_points num_obs', then per observation 'cam pt x y', then
    per camera 9 values (angle-axis (3), t (3), f, k1, k2), then per point
    xyz. Every array is broadcast over `batch`."""
    device = resolve_device(device)
    with open(path) as f:
        tokens = f.read().split()
    nc, npts, nobs = (int(x) for x in tokens[:3])
    vals = np.asarray(tokens[3:], dtype=np.float64)
    obs = vals[: 4 * nobs].reshape(nobs, 4)
    cams = vals[4 * nobs : 4 * nobs + 9 * nc].reshape(nc, 9)
    pts = vals[4 * nobs + 9 * nc : 4 * nobs + 9 * nc + 3 * npts].reshape(npts, 3)

    rot = so3.exp(torch.as_tensor(cams[:, :3]))
    poses = torch.cat([rot, torch.as_tensor(cams[:, 3:6])[..., None]], -1)

    def b(x):
        x = torch.as_tensor(x, dtype=torch.float64)
        return x[:, None].expand((x.shape[0], batch) + tuple(x.shape[1:])).to(dtype=dtype, device=device)

    return BAProblem(
        poses=b(poses), points=b(pts), focals=b(cams[:, 6:7]), k1=b(cams[:, 7:8]),
        k2=b(cams[:, 8:9]), obs_cam=obs[:, 0].astype(np.int64), obs_pt=obs[:, 1].astype(np.int64),
        obs_img=b(obs[:, 2:4]),
    )


def save_bal(path, prob: BAProblem, batch_index: int = 0) -> None:
    """Write one batch element of a BAProblem in the BAL text format (the
    inverse of load_bal)."""
    poses = prob.poses[:, batch_index].detach().double().cpu()  # (C, 3, 4)
    aa = so3.log(poses[:, :, :3]).numpy()
    t = poses[:, :, 3].numpy()
    f, k1, k2 = (_host(x)[:, batch_index, 0] for x in (prob.focals, prob.k1, prob.k2))
    pts = _host(prob.points)[:, batch_index]
    obs_img = _host(prob.obs_img)[:, batch_index]
    with open(path, "w") as fh:
        fh.write(f"{poses.shape[0]} {pts.shape[0]} {len(prob.obs_cam)}\n")
        for o in range(len(prob.obs_cam)):
            fh.write(f"{int(prob.obs_cam[o])} {int(prob.obs_pt[o])} "
                     f"{obs_img[o, 0]:.17g} {obs_img[o, 1]:.17g}\n")
        for c in range(poses.shape[0]):
            for v in (*aa[c], *t[c], f[c], k1[c], k2[c]):
                fh.write(f"{v:.17g}\n")
        for p in range(pts.shape[0]):
            for v in pts[p]:
                fh.write(f"{v:.17g}\n")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_ba_objective(
    prob: BAProblem,
    dtype: torch.dtype = torch.float32,
    device=None,
    fix_first_camera: bool = True,
    gauge_target=None,
    weight=None,
    use_families: bool = True,
    robust_loss_cls=None,
    log_loss_radius=0.0,
):
    """Reprojection objective with a Local prior (weight 1e4) on camera 0 as
    gauge. Returns (objective, cameras, points): the two families, or the
    lists of individual variables with use_families=False. The aux arrays
    are gathered on the host; the compiled objective moves each to `device`
    in one copy.

    robust_loss_cls (e.g. core.HuberLoss) wraps each Reprojection cost in a
    RobustCostFunction whose log radius is one (1, 1) aux variable,
    "obs_log_radius", shared by every observation on both builders (the
    JAX package's per-cost builder gives each cost its own copy of the same
    value). log_loss_radius: a float, or a tensor that requires grad, which
    the solve then differentiates."""
    obj = core.Objective(dtype=dtype, device=device)
    if use_families:
        cams = core.SE3Family(prob.num_cameras, name="cam")
        pts = core.Point3Family(prob.num_points, name="pt")
    else:
        cams = [core.SE3(name=f"cam_{i}") for i in range(prob.num_cameras)]
        pts = [core.Point3(name=f"pt_{i}") for i in range(prob.num_points)]
    if fix_first_camera:
        target = prob.poses[0] if gauge_target is None else gauge_target
        obj.add(Local(cams[0], _host(target), core.ScaleCostWeight(1e4), name="gauge"))

    obs_cam, obs_pt = np.asarray(prob.obs_cam), np.asarray(prob.obs_pt)
    focals, k1, k2 = _host(prob.focals), _host(prob.k1), _host(prob.k2)
    obs_img = _host(prob.obs_img)
    robust = None
    if robust_loss_cls is not None:
        radius = (log_loss_radius.reshape(1, 1) if isinstance(log_loss_radius, torch.Tensor)
                  else np.full((1, 1), float(log_loss_radius)))
        radius = core.Variable(radius, name="obs_log_radius")
        robust = lambda cost, name: core.RobustCostFunction(cost, robust_loss_cls, radius, name=name)  # noqa: E731
    if use_families:
        template = Reprojection(
            cams[0],
            pts[0],
            focal_length=core.Variable(focals[obs_cam], name="obs_focal"),
            image_feature_point=core.Variable(obs_img, name="obs_img"),
            calib_k1=core.Variable(k1[obs_cam], name="obs_k1"),
            calib_k2=core.Variable(k2[obs_cam], name="obs_k2"),
            cost_weight=weight,
            name="obs_template",
        )
        if robust is not None:
            template = robust(template, "obs_robust_template")
        obj.add(core.CostFamily(template, members=[(cams, obs_cam), (pts, obs_pt)], name="obs"))
        return obj, cams, pts
    for oi, (ci, pi) in enumerate(zip(obs_cam.tolist(), obs_pt.tolist())):
        cost = Reprojection(cams[ci], pts[pi], focal_length=focals[ci], image_feature_point=obs_img[oi],
                            calib_k1=k1[ci], calib_k2=k2[ci], cost_weight=weight, name=f"obs_{oi}")
        obj.add(cost if robust is None else robust(cost, f"robs_{oi}"))
    return obj, cams, pts


def ba_values(prob: BAProblem, use_families: bool = True) -> Dict[str, torch.Tensor]:
    """The optimization variables' values: one (N, B, ...) array per family,
    or one (B, ...) array per variable."""
    if use_families:
        return {"cam": prob.poses, "pt": prob.points}
    vals = {f"cam_{i}": prob.poses[i] for i in range(prob.num_cameras)}
    vals.update({f"pt_{i}": prob.points[i] for i in range(prob.num_points)})
    return vals
