"""Carry a JAX-package PGO problem into the port (JAX counterpart: scripts/dump_problem_npz.py, the writer of these arrays).

The port's analog of converting weights: the JAX package's problem arrives
as numpy arrays under the keys `scripts/dump_problem_npz.py` writes
(`gt` (N,B,3,4), `edges` (E,2), `measurements` (E,B,3,4), `init` (N,B,3,4),
`prior_weight`), and comes out as the port's Objective plus its input dict,
so both packages solve the identical problem.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core import Objective
from .examples.pose_graph import build_pgo_objective, pose_values


def problem_from_arrays(
    arrays: Mapping[str, np.ndarray], dtype: torch.dtype = torch.float32, device="cpu"
) -> Tuple[Objective, Dict[str, torch.Tensor]]:
    gt = np.asarray(arrays["gt"])
    edges = [(int(i), int(j)) for i, j in np.asarray(arrays["edges"])]
    init = torch.as_tensor(np.array(arrays["init"]), dtype=dtype, device=device)
    obj, _ = build_pgo_objective(
        init.shape[0], edges, np.asarray(arrays["measurements"]), gt[0],
        dtype=dtype, device=device, prior_weight=float(arrays["prior_weight"]),
    )
    return obj, pose_values(init)


def load_problem_npz(path, dtype: torch.dtype = torch.float32, device="cpu"):
    """problem_from_arrays on an .npz written by scripts/dump_problem_npz.py."""
    with np.load(path) as f:
        arrays = {k: f[k] for k in ("gt", "edges", "measurements", "init", "prior_weight")}
    return problem_from_arrays(arrays, dtype=dtype, device=device)
