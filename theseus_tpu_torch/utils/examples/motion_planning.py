"""GPMP2-style 2-D motion planning: the trajectory objective, the planner, and the learnable initial-trajectory and collision-weight models (JAX counterpart: theseus_tpu/utils/examples/motion_planning.py).

A trajectory of num_time_steps + 1 Point2 poses and Vector(2) velocities
(block size 2 on the sparse path) with boundary costs on the start and
goal, a GP motion prior between consecutive steps and a collision hinge on
every pose but the first, against a 2-D signed distance field.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ... import core
from ...embodied import Collision2D, GPCostWeight, GPMotionModel, Local
from ...layer import TheseusLayer
from ...optim.nonlinear import LevenbergMarquardt
from ..checks import MLP, build_mlp


class MotionPlannerObjective(core.Objective):
    """Boundary costs, GP priors and a per-step collision hinge. Named
    inputs: start and goal (B, 2), sdf_origin (B, 2), sdf_data
    (B, map_size, map_size), cell_size (B, 1) and, with
    learnable_collision_weight, collision_w (B, 1)."""

    def __init__(
        self,
        map_size: int,
        epsilon_dist: float,
        total_time: float,
        collision_weight: float,
        Qc_inv,
        num_time_steps: int,
        boundary_weight: float = 100.0,
        dtype: torch.dtype = torch.float64,
        learnable_collision_weight: bool = False,
        device=None,
    ):
        super().__init__(dtype=dtype, device=device)
        self.num_time_steps = num_time_steps
        self.total_time = total_time
        dt = total_time / num_time_steps

        self.poses = [core.Point2(name=f"pose_{i}") for i in range(num_time_steps + 1)]
        self.velocities = [core.Vector(2, name=f"vel_{i}") for i in range(num_time_steps + 1)]
        self.start = core.Variable(np.zeros((1, 2)), name="start")
        self.goal = core.Variable(np.zeros((1, 2)), name="goal")
        self.sdf_origin = core.Variable(np.zeros((1, 2)), name="sdf_origin")
        self.sdf_data = core.Variable(np.ones((1, map_size, map_size)), name="sdf_data")
        self.cell_size = core.Variable(np.ones((1, 1)), name="cell_size")

        bw = core.ScaleCostWeight(float(boundary_weight))
        self.add(Local(self.poses[0], self.start, bw, name="start_cost"))
        self.add(Local(self.poses[-1], self.goal, bw, name="goal_cost"))
        zero_vel = np.zeros((1, 2))
        self.add(Local(self.velocities[0], zero_vel, bw, name="start_vel"))
        self.add(Local(self.velocities[-1], zero_vel, bw, name="goal_vel"))

        qc = np.asarray(torch.as_tensor(Qc_inv, dtype=torch.float64).cpu())
        if learnable_collision_weight:
            cw = core.ScaleCostWeight(core.Variable(np.full((1, 1), collision_weight), name="collision_w"))
        else:
            cw = core.ScaleCostWeight(float(collision_weight))
        for i in range(num_time_steps):
            self.add(GPMotionModel(
                self.poses[i], self.velocities[i], self.poses[i + 1], self.velocities[i + 1], dt,
                GPCostWeight(qc, dt, name=f"gpw_{i}"), name=f"gp_{i}",
            ))
        for i in range(1, num_time_steps + 1):
            self.add(Collision2D(
                self.poses[i], sdf_origin=self.sdf_origin, sdf_data=self.sdf_data, sdf_cell_size=self.cell_size,
                cost_eps=epsilon_dist, cost_weight=cw, name=f"collision_{i}",
            ))


class MotionPlanner:
    """Objective, optimizer and layer together. opt_kwargs go to the
    optimizer (linearization, adaptive_damping, ...)."""

    def __init__(
        self,
        map_size: int,
        epsilon_dist: float,
        total_time: float,
        collision_weight: float,
        Qc_inv,
        num_time_steps: int,
        optimizer_cls=LevenbergMarquardt,
        max_iterations: int = 50,
        dtype: torch.dtype = torch.float64,
        device=None,
        **opt_kwargs,
    ):
        self.objective = MotionPlannerObjective(
            map_size, epsilon_dist, total_time, collision_weight, Qc_inv, num_time_steps, dtype=dtype,
            learnable_collision_weight=opt_kwargs.pop("learnable_collision_weight", False), device=device,
        )
        self.optimizer = optimizer_cls(self.objective, max_iterations=max_iterations, **opt_kwargs)
        self.layer = TheseusLayer(self.optimizer)

    def straight_line_initialization(self, start, goal) -> Dict[str, torch.Tensor]:
        """Poses on the line from start to goal (B, 2), the constant
        velocity along it."""
        n = self.objective.num_time_steps
        ts = torch.linspace(0.0, 1.0, n + 1, dtype=start.dtype, device=start.device)[None, :, None]
        traj = start[:, None] + ts * (goal - start)[:, None]
        vel = ((goal - start) / self.objective.total_time)[:, None].expand(traj.shape)
        init = {f"pose_{i}": traj[:, i] for i in range(n + 1)}
        init.update({f"vel_{i}": vel[:, i] for i in range(n + 1)})
        return init

    def solve(self, start, goal, sdf_origin, sdf_data, cell_size,
              initialization: Optional[Dict] = None, **kwargs):
        """layer.forward from `initialization` (default the straight line);
        kwargs are the forward's optimizer_kwargs."""
        inputs = dict(initialization or self.straight_line_initialization(start, goal))
        inputs.update(start=start, goal=goal, sdf_origin=sdf_origin, sdf_data=sdf_data, cell_size=cell_size)
        return self.layer.forward(inputs, optimizer_kwargs=kwargs)

    def trajectory(self, values) -> torch.Tensor:
        """(B, num_time_steps + 1, 2)."""
        n = self.objective.num_time_steps
        return torch.stack([values[f"pose_{i}"] for i in range(n + 1)], dim=1)


def synthetic_maps(batch: int, map_size: int = 128, cell_size: float = 0.1, seed: int = 0, n_boxes: int = 6,
                   n_discs: int = 4, clearance: float = 0.8):
    """`batch` random planning problems from a numpy seed: each map holds
    n_boxes axis-aligned boxes (sides 0.4-2.4 m) and n_discs discs (radius
    0.4-1.2 m) at uniform positions, with the cells within `clearance` of
    the start and the goal kept free; start and goal at 0.09375 and 0.90625
    of the extent, half way up (examples/motion_planning_2d.py). Returns
    numpy float64 (sdf (B, map_size, map_size) by occupancy_to_sdf, start
    (B, 2), goal (B, 2))."""
    from ...embodied.collision import occupancy_to_sdf

    rng = np.random.default_rng(seed)
    extent = map_size * cell_size
    start = np.array([0.09375 * extent, 0.5 * extent])
    goal = np.array([0.90625 * extent, 0.5 * extent])
    centers = (np.arange(map_size) + 0.5) * cell_size
    x, y = np.meshgrid(centers, centers, indexing="xy")  # row ~ y, col ~ x
    sdfs = []
    for _ in range(batch):
        occ = np.zeros((map_size, map_size), dtype=bool)
        for c, half in zip(rng.uniform(0.0, extent, (n_boxes, 2)), rng.uniform(0.2, 1.2, (n_boxes, 2))):
            occ |= (np.abs(x - c[0]) <= half[0]) & (np.abs(y - c[1]) <= half[1])
        for c, r in zip(rng.uniform(0.0, extent, (n_discs, 2)), rng.uniform(0.4, 1.2, n_discs)):
            occ |= (x - c[0]) ** 2 + (y - c[1]) ** 2 <= r * r
        for p in (start, goal):
            occ &= (x - p[0]) ** 2 + (y - p[1]) ** 2 > clearance * clearance
        sdfs.append(occupancy_to_sdf(occ.astype(np.float64), cell_size))
    return np.stack(sdfs), np.tile(start, (batch, 1)), np.tile(goal, (batch, 1))


class InitialTrajectoryModel(nn.Module):
    """An MLP from (start, goal) to a full initial trajectory: a residual
    of 0.1 times its output on the straight line and the constant velocity.
    Its MLP is [4, hidden, hidden, 4 (num_time_steps + 1)], drawn from
    `generator`, or `mlp` as given (`utils.convert.mlp_from_params`)."""

    def __init__(self, num_time_steps: int, generator: Optional[torch.Generator] = None, hidden: int = 64,
                 mlp: Optional[MLP] = None, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_time_steps = num_time_steps
        self.mlp = mlp if mlp is not None else build_mlp(
            [4, hidden, hidden, 4 * (num_time_steps + 1)], generator, dtype=dtype, device=device)

    def forward(self, start, goal, total_time: float) -> Dict[str, torch.Tensor]:
        n = self.num_time_steps
        raw = self.mlp(torch.cat([start, goal], dim=-1)).reshape(start.shape[0], n + 1, 4)
        ts = torch.linspace(0.0, 1.0, n + 1, dtype=start.dtype, device=start.device)[None, :, None]
        line = start[:, None] + ts * (goal - start)[:, None]
        vel0 = ((goal - start) / total_time)[:, None].expand(line.shape)
        poses = line + 0.1 * raw[..., :2]
        vels = vel0 + 0.1 * raw[..., 2:]
        init = {f"pose_{i}": poses[:, i] for i in range(n + 1)}
        init.update({f"vel_{i}": vels[:, i] for i in range(n + 1)})
        return init


class CollisionWeightModel(nn.Module):
    """A per-problem feature (B, 1) to a positive collision weight (B, 1):
    softplus of an MLP [1, hidden, 1] (log(1 + e^x) without torch's linear
    cut-over, as jax.nn.softplus), plus 1e-4."""

    def __init__(self, generator: Optional[torch.Generator] = None, hidden: int = 32, mlp: Optional[MLP] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.mlp = mlp if mlp is not None else build_mlp([1, hidden, 1], generator, dtype=dtype, device=device)

    def forward(self, feature):
        x = self.mlp(feature)
        return torch.logaddexp(x, torch.zeros_like(x)) + 1e-4
