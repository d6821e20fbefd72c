"""Synthetic pose-graph problems (JAX counterpart: theseus_tpu/utils/examples/pose_graph.py).

`synthetic_pose_graph` builds a batched SE3 chain with two loop closures:
ground truth from random steps, noisy relative measurements and a noisy
initialization, with the JAX package's noise scales (0.3 / 0.05 / 0.2). The
random numbers come from a numpy Generator seeded by `seed`, so the problem
is reproducible without JAX; they are not the JAX package's numbers (its
generator is jax.random). To solve the JAX package's exact arrays, load them
with utils/convert.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...core import Objective, ScaleCostWeight
from ...core.variable import SE3
from ...embodied import Between, Local
from ...lie import se3


def chain_edges(n_poses: int, extra_loop_closures: bool = True) -> List[Tuple[int, int]]:
    edges = [(i, i + 1) for i in range(n_poses - 1)]
    if extra_loop_closures:
        edges += [(n_poses - 1, 0), (0, n_poses // 2)]
    return edges


def synthetic_pose_graph(
    n_poses: int = 64,
    batch: int = 16,
    seed: int = 0,
    step_scale: float = 0.3,
    meas_noise: float = 0.05,
    init_noise: float = 0.2,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    extra_loop_closures: bool = True,
):
    """Returns (gt (N,B,3,4), edges, measurements (E,B,3,4), init (N,B,3,4)).
    Generated in float64 on the CPU, then cast to (dtype, device)."""
    edges = chain_edges(n_poses, extra_loop_closures)
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float64)

    steps = se3.exp(step_scale * normal(n_poses - 1, batch, 6))
    poses = [se3.identity(batch, dtype=torch.float64, device="cpu")]
    for i in range(n_poses - 1):
        poses.append(se3.compose(poses[-1], steps[i]))
    gt = torch.stack(poses)
    e = torch.as_tensor(edges)
    rel = se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]])
    measurements = se3.compose(rel, se3.exp(meas_noise * normal(len(edges), batch, 6)))
    init = se3.compose(gt, se3.exp(init_noise * normal(n_poses, batch, 6)))
    cast = lambda t: t.to(dtype=dtype, device=device)  # noqa: E731
    return cast(gt), edges, cast(measurements), cast(init)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_pgo_objective(
    n_poses: int,
    edges: List[Tuple[int, int]],
    measurements,
    prior_target,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    edge_weight=None,
    prior_weight: float = 10.0,
):
    """Objective over named SE3 pose variables: a Local prior on pose_0 and a
    Between cost per edge. Measurements are sliced on the host; the compiled
    objective stacks them and moves them to `device` in one copy."""
    obj = Objective(dtype=dtype, device=device)
    poses = [SE3(name=f"pose_{i}") for i in range(n_poses)]
    obj.add(Local(poses[0], _host(prior_target), ScaleCostWeight(float(prior_weight)), name="prior"))
    meas = _host(measurements)
    for ei, (i, j) in enumerate(edges):
        obj.add(Between(poses[i], poses[j], meas[ei], cost_weight=edge_weight, name=f"edge_{ei}"))
    return obj, poses


def pose_values(init) -> Dict[str, object]:
    """(N, B, 3, 4) stacked initialization -> {pose_i: (B, 3, 4)}."""
    return {f"pose_{i}": init[i] for i in range(init.shape[0])}
