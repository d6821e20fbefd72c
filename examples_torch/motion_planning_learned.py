"""Learned motion planning: train an initial-trajectory model through the planner (the port of examples/motion_planning_learned.py).

An MLP maps (start, goal) to an initial trajectory; the differentiable
MotionPlanner refines it for a fixed small number of LM iterations
(truncated backward over the last one), and the outer loss is the
solution's objective error, so the model learns initializations from
which a few planner iterations reach a good trajectory. A scalar
collision-weight model is trained jointly from an SDF clearance feature.
Problems (two disc obstacles a map, jittered start and goal) are drawn
from a CPU torch.Generator seeded 0; the models from generators
seeded 1 and 2. Runs on the card unless --device cpu is given.

    python examples_torch/motion_planning_learned.py [--steps 10] [--batch 4] [--inner-iters 3] [--device cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _config
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.motion_planning import (CollisionWeightModel, InitialTrajectoryModel,
                                                              MotionPlanner)

MAP_SIZE = 16
CELL = 0.25
NUM_STEPS = 10
TOTAL_TIME = 2.0


def draw_problems(batch, generator):
    """(centers (B, 2, 2), radii (B, 2), jitter (B, 4)) in float64."""
    side = MAP_SIZE * CELL
    centers = 0.8 + (side - 1.6) * torch.rand((batch, 2, 2), generator=generator, dtype=torch.float64)
    radii = 0.3 + 0.3 * torch.rand((batch, 2), generator=generator, dtype=torch.float64)
    jitter = 0.3 * torch.randn((batch, 4), generator=generator, dtype=torch.float64)
    return centers, radii, jitter


def problems(centers, radii, jitter):
    """(start (B, 2), goal (B, 2), sdf (B, H, W)): the signed distance to the
    nearer of two discs on a MAP_SIZE^2 grid of cells CELL wide; start and
    goal half a metre in from opposite corners, jittered."""
    xs = (torch.arange(MAP_SIZE, dtype=centers.dtype, device=centers.device) + 0.5) * CELL
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2), x along columns
    d = torch.linalg.norm(grid[None, None] - centers[:, :, None, None], dim=-1) - radii[:, :, None, None]
    sdf = d.min(dim=1).values
    side = MAP_SIZE * CELL
    base = torch.tensor([[0.5, 0.5, side - 0.5, side - 0.5]], dtype=centers.dtype, device=centers.device)
    pts = base + jitter
    return pts[:, :2], pts[:, 2:], sdf


def make_planner(inner_iters, dtype=torch.float64, device=None):
    return MotionPlanner(map_size=MAP_SIZE, epsilon_dist=0.4, total_time=TOTAL_TIME, collision_weight=20.0,
                         Qc_inv=[[1.0, 0.0], [0.0, 1.0]], num_time_steps=NUM_STEPS, max_iterations=inner_iters,
                         dtype=dtype, device=device, learnable_collision_weight=True)


def loss_fn(planner, traj_model, cw_model, start, goal, sdf):
    """The mean objective error after the planner's iterations from the
    model's initialization, the last iteration differentiated."""
    b = start.shape[0]
    obj = planner.objective
    co = obj.compile()
    init = traj_model(start, goal, TOTAL_TIME)
    feat = torch.mean(torch.clamp(sdf, max=1.0), dim=(1, 2))[:, None]  # clearance feature
    values = dict(init, start=start, goal=goal, sdf_origin=torch.zeros((b, 2), dtype=sdf.dtype, device=sdf.device),
                  sdf_data=sdf, cell_size=torch.full((b, 1), CELL, dtype=sdf.dtype, device=sdf.device),
                  collision_w=cw_model(feat))
    values = obj.default_values(values)
    carry = planner.layer.solve_state(co.pack(values, b), co.build_aux(values, b), "truncated",
                                      planner.optimizer.opts, 1)
    return torch.mean(carry["err"])


def train(steps=10, batch=4, inner_iters=3, seed=0, device=None, verbose=True):
    dev = config.resolve_device(device)
    dtype = torch.float64
    planner = make_planner(inner_iters, dtype, dev)
    traj_model = InitialTrajectoryModel(NUM_STEPS, torch.Generator().manual_seed(1), dtype=dtype, device=dev)
    cw_model = CollisionWeightModel(torch.Generator().manual_seed(2), dtype=dtype, device=dev)
    params = list(traj_model.parameters()) + list(cw_model.parameters())
    adam = torch.optim.Adam(params, lr=1e-3)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        start, goal, sdf = problems(*(t.to(dev) for t in draw_problems(batch, gen)))
        adam.zero_grad()
        loss = loss_fn(planner, traj_model, cw_model, start, goal, sdf)
        loss.backward()
        adam.step()
        losses.append(float(loss.detach()))
        if verbose and (i % 2 == 0 or i == steps - 1):
            print(f"step {i:3d}  planner err {losses[-1]:.5f}", flush=True)
    if verbose:
        print(f"({(time.perf_counter() - t0) / steps * 1e3:.0f} ms/step)")
    return losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--inner-iters", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = _config.parse_with_config(p, argv)
    losses = train(a.steps, a.batch, a.inner_iters, 0, a.device)
    first, best = losses[0], min(losses)
    print(f"planner error: first {first:.5f} -> best {best:.5f}")
    assert best < first, "outer training must reduce the planner error"


if __name__ == "__main__":
    main()
