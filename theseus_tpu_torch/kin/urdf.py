"""Minimal URDF parser, stdlib xml.etree and numpy (JAX counterpart: theseus_tpu/kin/urdf.py).

Parses only what kinematics needs: links, joints (type, parent, child,
origin xyz/rpy, axis, limits, dynamics, mimic). The port keeps its own copy
so that it imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class UrdfJoint:
    name: str
    type: str  # revolute | continuous | prismatic | fixed | floating | planar
    parent: str
    child: str
    origin_xyz: Tuple[float, float, float]
    origin_rpy: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    lower: Optional[float] = None
    upper: Optional[float] = None
    effort: Optional[float] = None
    velocity: Optional[float] = None
    damping: Optional[float] = None
    friction: Optional[float] = None
    # <mimic joint="..." multiplier="..." offset="..."/>: this joint's value
    # is multiplier * q[mimic_joint] + offset (URDF spec)
    mimic_joint: Optional[str] = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0


@dataclasses.dataclass
class UrdfRobot:
    name: str
    links: List[str]
    joints: List[UrdfJoint]


def _floats(s: Optional[str], default):
    if s is None:
        return default
    return tuple(float(x) for x in s.split())


def parse_urdf(source: str, from_string: bool = False) -> UrdfRobot:
    root = ET.fromstring(source) if from_string else ET.parse(source).getroot()
    if root.tag != "robot":
        raise ValueError("not a URDF robot file")
    links = [l.attrib["name"] for l in root.findall("link")]
    joints = []
    for j in root.findall("joint"):
        origin = j.find("origin")
        xyz = _floats(origin.attrib.get("xyz") if origin is not None else None, (0.0, 0.0, 0.0))
        rpy = _floats(origin.attrib.get("rpy") if origin is not None else None, (0.0, 0.0, 0.0))
        axis_el = j.find("axis")
        axis = _floats(axis_el.attrib.get("xyz") if axis_el is not None else None, (1.0, 0.0, 0.0))
        limit = j.find("limit")
        lower = upper = effort = velocity = None
        if limit is not None:
            if "lower" in limit.attrib:
                lower = float(limit.attrib["lower"])
            if "upper" in limit.attrib:
                upper = float(limit.attrib["upper"])
            if "effort" in limit.attrib:
                effort = float(limit.attrib["effort"])
            if "velocity" in limit.attrib:
                velocity = float(limit.attrib["velocity"])
        dyn = j.find("dynamics")
        damping = float(dyn.attrib["damping"]) if dyn is not None and "damping" in dyn.attrib else None
        friction = float(dyn.attrib["friction"]) if dyn is not None and "friction" in dyn.attrib else None
        mimic = j.find("mimic")
        mimic_joint = None
        mimic_multiplier, mimic_offset = 1.0, 0.0
        if mimic is not None:
            mimic_joint = mimic.attrib["joint"]
            mimic_multiplier = float(mimic.attrib.get("multiplier", 1.0))
            mimic_offset = float(mimic.attrib.get("offset", 0.0))
        joints.append(
            UrdfJoint(
                name=j.attrib["name"],
                type=j.attrib["type"],
                parent=j.find("parent").attrib["link"],
                child=j.find("child").attrib["link"],
                origin_xyz=xyz,
                origin_rpy=rpy,
                axis=axis,
                lower=lower,
                upper=upper,
                effort=effort,
                velocity=velocity,
                damping=damping,
                friction=friction,
                mimic_joint=mimic_joint,
                mimic_multiplier=mimic_multiplier,
                mimic_offset=mimic_offset,
            )
        )
    return UrdfRobot(name=root.attrib.get("name", "robot"), links=links, joints=joints)


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw -> rotation matrix (R = Rz Ry Rx)."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def origin_pose(j: UrdfJoint) -> np.ndarray:
    """(3, 4) [R | t] for the joint origin."""
    r = rpy_to_matrix(j.origin_rpy)
    t = np.asarray(j.origin_xyz).reshape(3, 1)
    return np.concatenate([r, t], axis=1)
