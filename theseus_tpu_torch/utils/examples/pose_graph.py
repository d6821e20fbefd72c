"""Synthetic pose-graph problems (JAX counterpart: theseus_tpu/utils/examples/pose_graph.py).

`synthetic_pose_graph` builds a batched SE3 chain with two loop closures:
ground truth from random steps, noisy relative measurements and a noisy
initialization, with the JAX package's noise scales (0.3 / 0.05 / 0.2). The
random numbers come from a numpy Generator seeded by `seed`, so the problem
is reproducible without JAX; they are not the JAX package's numbers (its
generator is jax.random). To solve the JAX package's exact arrays, load them
with utils/convert.py.

`read_3d_g2o` reads a g2o file of SE3 vertices and edges (the format of
the public pose-graph datasets) into torch tensors on the card, or on the
`device` given, ready for `build_pgo_objective`; `read_2d_g2o` does the
same for SE2 graphs (`VERTEX_SE2` / `EDGE_SE2`, the format of M3500 and
the other 2-D benchmarks).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...config import resolve_device
from ...core import Objective, ScaleCostWeight
from ...core.variable import SE3, Variable
from ...embodied import Between, Local
from ...lie import se3, so3


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
    device=None,
    extra_loop_closures: bool = True,
):
    """Returns (gt (N,B,3,4), edges, measurements (E,B,3,4), init (N,B,3,4)).
    Generated in float64 on the CPU, then cast to (dtype, device); device
    None is the card (config.default_device)."""
    device = resolve_device(device)
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
    device=None,
    edge_weight=None,
    prior_weight: float = 10.0,
    loop_weight=None,
):
    """Objective over named SE3 pose variables: a Local prior on pose_0 and a
    Between cost per edge. Measurements are sliced on the host; the compiled
    objective stacks them and moves them to `device` in one copy.

    loop_weight, when given, weighs the edges after the first n_poses - 1
    (the loop closures of `chain_edges`) and edge_weight the odometry edges
    before them: the training problem of the flagship, whose outer loss
    learns a loop-closure weight (see `training_weights`)."""
    obj = Objective(dtype=dtype, device=device)
    poses = [SE3(name=f"pose_{i}") for i in range(n_poses)]
    obj.add(Local(poses[0], _host(prior_target), ScaleCostWeight(float(prior_weight)), name="prior"))
    meas = _host(measurements)
    for ei, (i, j) in enumerate(edges):
        w = loop_weight if loop_weight is not None and ei >= n_poses - 1 else edge_weight
        obj.add(Between(poses[i], poses[j], meas[ei], cost_weight=w, name=f"edge_{ei}"))
    return obj, poses


def training_weights():
    """(edge_weight, loop_weight) for `build_pgo_objective`: odometry weight 1
    and a loop-closure weight held by the aux variable "w_loop", which an
    outer loop passes in as a (1, 1) tensor that requires grad."""
    w_odo = ScaleCostWeight(Variable(np.ones((1, 1)), name="w_odo"))
    w_loop = ScaleCostWeight(Variable(np.ones((1, 1)), name="w_loop"))
    return w_odo, w_loop


def mean_sq_local(values: Dict[str, torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
    """The flagship's outer loss: the mean over poses and batch of the squared
    SE3 `local` (log(pose^{-1} gt)) from each solved pose to its ground truth
    gt (N, B, 3, 4)."""
    sol = torch.stack([values[f"pose_{i}"] for i in range(gt.shape[0])])
    d = se3.log(se3.compose(se3.inverse(sol), gt))
    return torch.mean(torch.sum(d * d, dim=-1))


def pose_values(init) -> Dict[str, object]:
    """(N, B, 3, 4) stacked initialization -> {pose_i: (B, 3, 4)}."""
    return {f"pose_{i}": init[i] for i in range(init.shape[0])}


def read_3d_g2o(path, dtype: torch.dtype = torch.float64, device=None):
    """VERTEX_SE3:QUAT / EDGE_SE3:QUAT reader. Returns (num_poses, poses
    (N, 1, 3, 4), edges [(i, j)], measurements (E, 1, 3, 4), weights
    (E, 6, 6)): the weights are the upper-triangular sqrt-information
    W = L^T of each edge's information matrix info = L L^T, so W^T W = info
    (g2o stores info's upper triangle, row by row). Vertices are numbered
    0 .. N-1. Parsed in float64 on the host, then cast to (dtype, device);
    device None is the card (config.default_device)."""
    device = resolve_device(device)
    verts: Dict[int, List[float]] = {}
    edges: List[Tuple[int, int]] = []
    meas, infos = [], []
    iu = np.triu_indices(6)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                verts[int(tok[1])] = [x, y, z, qw, qx, qy, qz]
            elif tok[0] == "EDGE_SE3:QUAT":
                edges.append((int(tok[1]), int(tok[2])))
                x, y, z, qx, qy, qz, qw = map(float, tok[3:10])
                meas.append([x, y, z, qw, qx, qy, qz])
                info = np.zeros((6, 6))
                info[iu] = list(map(float, tok[10:31]))
                infos.append(info + np.triu(info, 1).T)
    n = len(verts)

    def to_se3(rows):
        a = torch.as_tensor(np.asarray(rows), dtype=torch.float64)
        return torch.cat([so3.quaternion_to_rotation(a[:, 3:7]), a[:, :3, None]], dim=-1)[:, None]

    def cast(t):
        return t.to(dtype=dtype, device=device)

    weights = torch.as_tensor(np.stack([np.linalg.cholesky(i).T for i in infos]))
    return n, cast(to_se3([verts[i] for i in range(n)])), edges, cast(to_se3(meas)), cast(weights)


def read_2d_g2o(path, dtype: torch.dtype = torch.float64, device=None):
    """VERTEX_SE2 / EDGE_SE2 reader. Returns (num_poses, poses (N, 1, 4),
    edges [(i, j)], measurements (E, 1, 4), weights (E, 3, 3)): elements
    are (x, y, cos t, sin t) and the weights the upper-triangular
    sqrt-information W = L^T of each info = L L^T. Parsed in float64 on the
    host, then cast to (dtype, device); device None is the card
    (config.default_device). A line with missing fields raises."""
    device = resolve_device(device)
    verts: Dict[int, List[float]] = {}
    edges: List[Tuple[int, int]] = []
    meas, infos = [], []
    iu = np.triu_indices(3)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE2":
                x, y, th = map(float, tok[2:5])
                verts[int(tok[1])] = [x, y, np.cos(th), np.sin(th)]
            elif tok[0] == "EDGE_SE2":
                edges.append((int(tok[1]), int(tok[2])))
                x, y, th = map(float, tok[3:6])
                meas.append([x, y, np.cos(th), np.sin(th)])
                info = np.zeros((3, 3))
                info[iu] = list(map(float, tok[6:12]))
                infos.append(info + np.triu(info, 1).T)
    n = len(verts)

    def cast(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64).to(dtype=dtype, device=device)

    weights = np.stack([np.linalg.cholesky(i).T for i in infos])
    return n, cast([verts[i] for i in range(n)])[:, None], edges, cast(meas)[:, None], cast(weights)
