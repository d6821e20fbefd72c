"""Carry a JAX-package PGO or BA problem, or an MLP's parameters, into the port (JAX counterpart: scripts/dump_problem_npz.py, the writer of the PGO arrays).

The port's analog of converting weights: the JAX package's problem arrives
as numpy arrays and comes out as the port's problem, so both packages solve
the identical problem.

- PGO, under the keys `scripts/dump_problem_npz.py` writes: `gt` (N,B,3,4),
  `edges` (E,2), `measurements` (E,B,3,4), `init` (N,B,3,4),
  `prior_weight`; out comes the port's Objective plus its input dict.
- BA, the fields of the JAX package's `BAProblem`: `poses` (C,B,3,4),
  `points` (P,B,3), `focals`, `k1`, `k2` (C,B,1), `obs_cam`, `obs_pt` (O,),
  `obs_img` (O,B,2), optionally `gt_poses`, `gt_points`; out comes the
  port's BAProblem (build its objective with `build_ba_objective`).
- An MLP of the JAX package's `utils/checks.py` `build_mlp`: its params, a
  list of {"w": (n_in, n_out), "b": (n_out,)} arrays, become the port's
  `utils.checks.MLP` with the same layout (the motion-planning models take
  it as `mlp=`); the tactile trainer's {"meas", "weight"} params become its
  two models (`tactile_models_from_params`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..core import Objective
from .checks import MLP
from .examples.bundle_adjustment import BAProblem
from .examples.pose_graph import build_pgo_objective, pose_values


def problem_from_arrays(
    arrays: Mapping[str, np.ndarray], dtype: torch.dtype = torch.float32, device=None
) -> Tuple[Objective, Dict[str, torch.Tensor]]:
    gt = np.asarray(arrays["gt"])
    edges = [(int(i), int(j)) for i, j in np.asarray(arrays["edges"])]
    device = resolve_device(device)
    init = torch.as_tensor(np.array(arrays["init"]), dtype=dtype, device=device)
    obj, _ = build_pgo_objective(
        init.shape[0], edges, np.asarray(arrays["measurements"]), gt[0],
        dtype=dtype, device=device, prior_weight=float(arrays["prior_weight"]),
    )
    return obj, pose_values(init)


def load_problem_npz(path, dtype: torch.dtype = torch.float32, device=None):
    """problem_from_arrays on an .npz written by scripts/dump_problem_npz.py."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in ("gt", "edges", "measurements", "init", "prior_weight")}
    return problem_from_arrays(arrays, dtype=dtype, device=device)


BA_KEYS = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img")


def ba_problem_from_arrays(
    arrays: Mapping[str, np.ndarray], dtype: torch.dtype = torch.float32, device=None
) -> BAProblem:
    device = resolve_device(device)

    def t(k):
        return torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=device)

    gt = {k: t(k) for k in ("gt_poses", "gt_points") if k in arrays}
    return BAProblem(
        poses=t("poses"), points=t("points"), focals=t("focals"), k1=t("k1"), k2=t("k2"),
        obs_cam=np.asarray(arrays["obs_cam"], np.int64), obs_pt=np.asarray(arrays["obs_pt"], np.int64),
        obs_img=t("obs_img"), **gt,
    )


def load_ba_npz(path, dtype: torch.dtype = torch.float32, device=None) -> BAProblem:
    """ba_problem_from_arrays on an .npz holding a BAProblem's arrays."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in BA_KEYS + ("gt_poses", "gt_points") if k in f}
    return ba_problem_from_arrays(arrays, dtype=dtype, device=device)


def mlp_from_params(params, dtype: torch.dtype = torch.float32, device=None, activation=torch.relu) -> MLP:
    """The JAX package's build_mlp params (a list of {"w", "b"} arrays) as
    the port's MLP module."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return MLP([t(p["w"]) for p in params], [t(p["b"]) for p in params], activation)


def tactile_models_from_params(params, dtype: torch.dtype = torch.float32, device=None):
    """The JAX package's `create_tactile_models` params {"meas", "weight"}
    as the port's (TactileMeasurementModel, TactileWeightModel), for
    `TactileTrainer(..., models=...)`."""
    from .examples.tactile_pose_estimation import TactileMeasurementModel, TactileWeightModel

    meas = mlp_from_params(params["meas"], dtype=dtype, device=device)
    feature_dim = meas.weights[0].shape[0] // 2
    return (TactileMeasurementModel(feature_dim, mlp=meas),
            TactileWeightModel(mlp=mlp_from_params(params["weight"], dtype=dtype, device=device)))


def tactile_params_from_arrays(arrays: Mapping[str, np.ndarray]):
    """The {"meas", "weight"} params from flat arrays `meas_w0`, `meas_b0`,
    ..., `weight_w0`, ... (scripts/make_tactile_golden.py writes them so)."""
    def layers(part):
        n = sum(1 for k in arrays if k.startswith(f"{part}_w"))
        return [{"w": np.asarray(arrays[f"{part}_w{i}"]), "b": np.asarray(arrays[f"{part}_b{i}"])} for i in range(n)]

    return {"meas": layers("meas"), "weight": layers("weight")}
