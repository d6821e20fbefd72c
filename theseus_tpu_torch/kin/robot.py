"""Robot model: static kinematic structure from a URDF (JAX counterpart: theseus_tpu/kin/robot.py).

Parses the URDF, folds fixed joints into static offsets, orders the actuated
joints topologically, resolves mimic joints onto the dof they follow and
records per-link ancestor chains, as numpy and Python structure that the FK
functions (kin/fk.py) read. The port keeps its own copy so that it imports
nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .urdf import UrdfRobot, origin_pose, parse_urdf

_REV_TYPES = ("revolute", "continuous")
_PRISM_TYPES = ("prismatic",)


@dataclasses.dataclass
class JointSpec:
    name: str
    kind: str  # "revolute" | "prismatic"
    axis: np.ndarray  # (3,) unit
    origin: np.ndarray  # (3, 4) parent_link -> joint frame (fixed part)
    parent_link: str
    child_link: str
    index: int  # position in robot.joints (pose chain index)
    dof_index: int  # column of the angle vector driving this joint
    parent_joint: Optional[int]  # robot.joints index of nearest actuated ancestor
    # mimic joints (URDF <mimic>): q_joint = mimic_mult * q[dof_index] + mimic_off;
    # they share the mimicked joint's dof
    mimic_of: Optional[str] = None
    mimic_mult: float = 1.0
    mimic_off: float = 0.0


class Robot:
    def __init__(self, urdf: UrdfRobot):
        self.name = urdf.name
        by_child: Dict[str, int] = {}
        for i, j in enumerate(urdf.joints):
            if j.child in by_child:
                raise ValueError(f"link {j.child} has two parent joints")
            by_child[j.child] = i
        roots = [l for l in urdf.links if l not in by_child]
        if len(roots) != 1:
            raise ValueError(f"expected a single root link, got {roots}")
        self.base_link = roots[0]

        # walk up from each link folding fixed joints; assign dof ids in
        # URDF declaration order of actuated joints
        self.joints: List[JointSpec] = []
        self._n_dofs = 0
        self._limits: List[Tuple] = []  # (lower, upper, velocity, effort) per dof
        self._actuated_of_link: Dict[str, Optional[int]] = {self.base_link: None}
        self._offset_of_link: Dict[str, np.ndarray] = {
            self.base_link: np.hstack([np.eye(3), np.zeros((3, 1))])
        }
        self.joint_names: List[str] = []

        def se3_mul(a, b):
            r = a[:, :3] @ b[:, :3]
            t = a[:, :3] @ b[:, 3:] + a[:, 3:]
            return np.concatenate([r, t], axis=1)

        # process joints in topological order (parents first)
        remaining = list(range(len(urdf.joints)))
        processed_links = {self.base_link}
        progress = True
        while remaining and progress:
            progress = False
            for i in list(remaining):
                j = urdf.joints[i]
                if j.parent not in processed_links:
                    continue
                remaining.remove(i)
                progress = True
                origin = origin_pose(j)
                if j.type == "fixed":
                    # fold: child link = parent's actuated ancestor + offset
                    self._actuated_of_link[j.child] = self._actuated_of_link[j.parent]
                    self._offset_of_link[j.child] = se3_mul(
                        self._offset_of_link[j.parent], origin
                    )
                elif j.type in _REV_TYPES + _PRISM_TYPES:
                    kind = "revolute" if j.type in _REV_TYPES else "prismatic"
                    if j.mimic_joint is None:
                        dof_index = self._n_dofs
                        self._n_dofs += 1
                    else:
                        dof_index = -1  # resolved after the walk (forward refs ok)
                    spec = JointSpec(
                        name=j.name,
                        kind=kind,
                        axis=np.asarray(j.axis, dtype=np.float64),
                        origin=se3_mul(self._offset_of_link[j.parent], origin),
                        parent_link=j.parent,
                        child_link=j.child,
                        index=len(self.joints),
                        dof_index=dof_index,
                        parent_joint=self._actuated_of_link[j.parent],
                        mimic_of=j.mimic_joint,
                        mimic_mult=j.mimic_multiplier,
                        mimic_off=j.mimic_offset,
                    )
                    self.joints.append(spec)
                    if j.mimic_joint is None:
                        self.joint_names.append(j.name)
                        self._limits.append((j.lower, j.upper, j.velocity, j.effort))
                    self._actuated_of_link[j.child] = spec.index
                    self._offset_of_link[j.child] = np.hstack(
                        [np.eye(3), np.zeros((3, 1))]
                    )
                else:
                    raise ValueError(f"unsupported joint type {j.type}")
                processed_links.add(j.child)
        if remaining:
            raise ValueError("URDF joint graph is not a tree rooted at the base")
        self.link_names = list(processed_links)

        # resolve mimic references (may point forward in declaration order)
        by_name = {s.name: s for s in self.joints}
        for s in self.joints:
            if s.mimic_of is None:
                continue
            target = by_name.get(s.mimic_of)
            if target is None:
                raise ValueError(
                    f"joint {s.name} mimics unknown joint {s.mimic_of}"
                )
            if target.mimic_of is not None:
                raise ValueError(
                    f"joint {s.name} mimics {s.mimic_of}, which is itself a "
                    "mimic joint (chained mimics are not supported)"
                )
            s.dof_index = target.dof_index

    @property
    def dof(self) -> int:
        return self._n_dofs

    @property
    def joint_limits(self) -> np.ndarray:
        """(dof, 2) lower/upper position limits (inf where unspecified)."""
        out = np.full((self._n_dofs, 2), np.inf)
        out[:, 0] = -np.inf
        for i, (lo, hi, _, _) in enumerate(self._limits):
            if lo is not None:
                out[i, 0] = lo
            if hi is not None:
                out[i, 1] = hi
        return out

    @property
    def velocity_limits(self) -> np.ndarray:
        """(dof,) velocity limits (inf where unspecified)."""
        out = np.full((self._n_dofs,), np.inf)
        for i, (_, _, v, _) in enumerate(self._limits):
            if v is not None:
                out[i] = v
        return out

    def link_offset(self, link: str) -> np.ndarray:
        """Static (3,4) offset from the link's nearest actuated joint frame."""
        return self._offset_of_link[link]

    def link_parent_joint(self, link: str) -> Optional[int]:
        return self._actuated_of_link[link]

    def ancestor_joints(self, link: str) -> List[int]:
        """Actuated joints from root to the link (inclusive)."""
        out = []
        ji = self._actuated_of_link[link]
        while ji is not None:
            out.append(ji)
            ji = self.joints[ji].parent_joint
        return out[::-1]

    @classmethod
    def from_urdf_file(cls, path: str) -> "Robot":
        return cls(parse_urdf(path))

    @classmethod
    def from_urdf_string(cls, s: str) -> "Robot":
        return cls(parse_urdf(s, from_string=True))
