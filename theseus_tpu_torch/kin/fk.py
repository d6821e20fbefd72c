"""Differentiable forward kinematics with analytic body and spatial jacobians (JAX counterpart: theseus_tpu/kin/fk.py).

The kinematic tree is static structure, so FK is an unrolled chain of SE3
composes in plain torch ops over any leading batch dims; it runs unchanged
under torch.func.vmap and jacfwd. The jacobians are analytic screw-axis
columns, J_b[:, i] = Adj(T_link^{-1} T_i) xi_i, and `torch.func.jacfwd(fk)`
agrees with them (the Lie exp/log carry their analytic JVP rules).

The constants (each joint's origin folded into its Rodrigues terms, the
screws, the link offsets) are built once per (device, dtype) and kept by
the functions that `get_forward_kinematics_fns` returns, so FK inside a
solve copies nothing from the host; folding the origins keeps each joint
to a few ops, which is what FK costs under torch.func's per-op dispatch.

Tangent convention: [linear(3); angular(3)], as in lie/se3.py.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..lie import se3
from ..lie.utils import mvp
from .robot import Robot


class _Tables:
    """A robot's FK constants as tensors, per (device, dtype).

    Each joint's origin O = [O_R | O_t] is folded into its motion: a
    revolute joint's child frame relative to its parent link is
    [c O_R + s O_R hat(a) + (1 - c) O_R a a^T | O_t] (Rodrigues about the
    unit axis a, c = cos q, s = sin q), a prismatic joint's
    [O_R | q O_R a + O_t]."""

    def __init__(self, robot: Robot, link_names: Sequence[str] = ()):
        self.robot = robot
        self.link_names = list(link_names)
        self._on: Dict[Tuple[str, torch.dtype], Dict[str, torch.Tensor]] = {}

    def on(self, like: torch.Tensor) -> Dict[str, torch.Tensor]:
        key = (str(like.device), like.dtype)
        if key not in self._on:
            joints = self.robot.joints
            origin = np.stack([j.origin for j in joints]) if joints else np.zeros((0, 3, 4))
            axis = np.stack([j.axis for j in joints]) if joints else np.zeros((0, 3))
            o_r = origin[:, :, :3]
            hat = np.zeros((len(joints), 3, 3))
            hat[:, 0, 1], hat[:, 0, 2], hat[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
            hat -= hat.transpose(0, 2, 1)

            def t(a):
                return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=like.dtype, device=like.device)

            offsets = [self.robot.link_offset(n) for n in self.link_names]
            self._on[key] = {
                "o_r": t(o_r),
                "o_t": t(origin[:, :, 3]),
                "o_r_hat": t(o_r @ hat),
                "o_r_outer": t(o_r @ (axis[:, :, None] * axis[:, None, :])),
                "o_r_axis": t(np.einsum("jab,jb->ja", o_r, axis)),
                # [lin; ang]: a revolute joint turns about its axis, a prismatic slides along it
                "screw": t(np.stack([np.concatenate([np.zeros(3), j.axis]) if j.kind == "revolute"
                                     else np.concatenate([j.axis, np.zeros(3)]) for j in joints])
                           if joints else np.zeros((0, 6))),
                "offset": t(np.stack(offsets) if offsets else np.zeros((0, 3, 4))),
            }
        return self._on[key]


def _local_frame(kind: str, c: Dict[str, torch.Tensor], i: int, theta):
    """(...,) joint value -> the child frame in its parent link's frame, as
    (R (..., 3, 3), t (..., 3))."""
    if kind == "revolute":
        cos, sin = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
        r = cos * c["o_r"][i] + sin * c["o_r_hat"][i] + (1.0 - cos) * c["o_r_outer"][i]
        return r, c["o_t"][i].expand(r.shape[:-1])
    t = theta[..., None] * c["o_r_axis"][i] + c["o_t"][i]
    return c["o_r"][i].expand(t.shape + (3,)), t


def joint_child_poses(robot: Robot, angles, tables: _Tables = None):
    """angles (..., dof) -> list of (..., 3, 4) poses of each joint's child
    frame, in joint index order (parents first by construction). `tables`
    holds the constants; without it they are copied to the device anew."""
    c = (tables or _Tables(robot)).on(angles)
    frames = []
    for i, spec in enumerate(robot.joints):
        theta = angles[..., spec.dof_index]
        if spec.mimic_of is not None:
            theta = spec.mimic_mult * theta + spec.mimic_off
        r, t = _local_frame(spec.kind, c, i, theta)
        if spec.parent_joint is not None:
            rp, tp = frames[spec.parent_joint]
            r, t = rp @ r, mvp(rp, t) + tp
        frames.append((r, t))
    return [se3.from_rot_trans(r, t) for r, t in frames]


def get_forward_kinematics_fns(robot: Robot, link_names: Sequence[str]):
    """Returns (fk, jfk_b, jfk_s).

    fk(angles (..., dof)) -> tuple of (..., 3, 4) link poses;
    jfk_b / jfk_s(angles) -> (list of (..., 6, dof) body / spatial
    jacobians, tuple of poses)."""
    link_names = list(link_names)
    tables = _Tables(robot, link_names)
    parents = [robot.link_parent_joint(n) for n in link_names]
    ancestors = [robot.ancestor_joints(n) for n in link_names]

    def _poses(angles):
        c = tables.on(angles)
        jp = joint_child_poses(robot, angles, tables)
        out = []
        for li, pj in enumerate(parents):
            off = c["offset"][li]
            out.append(off.expand(angles.shape[:-1] + (3, 4)) if pj is None else se3.compose(jp[pj], off))
        return jp, tuple(out)

    def fk(angles):
        return _poses(angles)[1]

    def _jfk(angles, spatial: bool):
        c = tables.on(angles)
        jp, poses = _poses(angles)
        jacs = []
        for pose, anc in zip(poses, ancestors):
            cols = [angles.new_zeros(angles.shape[:-1] + (6,))] * robot.dof
            pose_inv = se3.inverse(pose)
            for ji in anc:
                spec = robot.joints[ji]
                frame = jp[ji] if spatial else se3.compose(pose_inv, jp[ji])
                col = mvp(se3.adjoint(frame), c["screw"][ji])
                if spec.mimic_of is not None:
                    col = spec.mimic_mult * col  # chain rule through the mimic map
                # a mimic joint shares its target's dof column: accumulate
                cols[spec.dof_index] = cols[spec.dof_index] + col
            jacs.append(torch.stack(cols, dim=-1))
        return jacs, poses

    def jfk_b(angles):
        return _jfk(angles, spatial=False)

    def jfk_s(angles):
        return _jfk(angles, spatial=True)

    return fk, jfk_b, jfk_s
