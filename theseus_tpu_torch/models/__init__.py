"""Model families: ready-made problem builders over the core framework (JAX counterpart: theseus_tpu/models/__init__.py).

- pose_graph: synthetic SE3 PGO generators, g2o loaders, objective builders
- bundle_adjustment: synthetic BA, BAL loader, Reprojection objectives
- motion_planning: GPMP2-style trajectory optimization (MotionPlanner)
- tactile: tactile pose estimation (quasi-static pushing + contact)
"""

from ..utils.examples import bundle_adjustment, motion_planning, pose_graph
from ..utils.examples import tactile_pose_estimation as tactile
from ..utils.examples.bundle_adjustment import BAProblem, ba_values, build_ba_objective, load_bal, synthetic_ba
from ..utils.examples.motion_planning import MotionPlanner, MotionPlannerObjective
from ..utils.examples.pose_graph import (
    build_pgo_objective,
    pose_values,
    read_2d_g2o,
    read_3d_g2o,
    synthetic_pose_graph,
)
from ..utils.examples.tactile_pose_estimation import TactilePoseEstimator
