"""Cost functions of the embodied library: measurements, priors, motion models, collision and kinematics models (JAX counterpart: theseus_tpu/embodied/__init__.py)."""

from .collision import Collision2D, EffectorObjectContactPlanar, occupancy_to_sdf, sdf_signed_distance
from .kinematics import IdentityModel, KinematicsModel, UrdfRobotModel
from .measurements import Between, MovingFrameBetween, Reprojection
from .misc import Difference, Local
from .motionmodel import (
    DoubleIntegrator,
    GPCostWeight,
    GPMotionModel,
    HingeCost,
    Nonholonomic,
    QuasiStaticPushingPlanar,
)

__all__ = [
    "Between",
    "Collision2D",
    "Difference",
    "DoubleIntegrator",
    "EffectorObjectContactPlanar",
    "GPCostWeight",
    "GPMotionModel",
    "HingeCost",
    "IdentityModel",
    "KinematicsModel",
    "Local",
    "MovingFrameBetween",
    "Nonholonomic",
    "QuasiStaticPushingPlanar",
    "Reprojection",
    "UrdfRobotModel",
    "occupancy_to_sdf",
    "sdf_signed_distance",
]
