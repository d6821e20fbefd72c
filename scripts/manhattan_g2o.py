#!/usr/bin/env python3
"""Write an SE2 pose graph of M3500's size and structure as a g2o file, from a seed.

M3500 (Olson, Leonard and Teller, "Fast iterative alignment of pose graphs
with poor initial estimates", ICRA 2006) is the standard 2-D pose-graph
benchmark: 3500 poses of a robot walking a Manhattan world, 3499 odometry
edges and 1954 loop closures, one information matrix for every edge, and
vertices initialised by composing the odometry. The published file is not
in this repository, so this script makes a graph of the same size and
structure:

- a walk of `--poses` unit steps on a square grid of cells (side
  `round(0.5 * sqrt(poses))`, 30 cells at 3500 poses), starting at the
  origin heading along +x; at each step it turns left or right with
  probability TURN_PROB, and it turns whenever the step would leave the
  grid;
- one odometry edge per step;
- loop closures wherever the walk revisits a cell, to the last
  LINKS_PER_REVISIT earlier visits of that cell; when there are more
  candidates than M3500's ratio of loop closures to poses allows
  (1954 / 3500, so 1954 at 3500 poses), that many are drawn at random;
- every measurement is the true relative pose (x, y, theta) plus Gaussian
  noise of SIGMA_XY metres in x and y and SIGMA_THETA radians in theta,
  and every edge carries the same information matrix,
  diag(1/SIGMA_XY^2, 1/SIGMA_XY^2, 1/SIGMA_THETA^2);
- vertex 0 is the true first pose (0, 0, 0); every other vertex composes
  the noisy odometry from it, as a g2o file's initial estimate does.

Run it as

    python3 scripts/manhattan_g2o.py --poses 3500 --seed 0 --out m3500.g2o

It uses numpy only. `generate` returns the arrays, `write_g2o` writes them.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import numpy as np

M3500_POSES = 3500
M3500_LOOP_CLOSURES = 1954
TURN_PROB = 0.25
LINKS_PER_REVISIT = 3
SIGMA_XY = 0.05  # metres, per axis, on every edge
SIGMA_THETA = 0.01  # radians, on every edge

_DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])  # headings 0, 90, 180, 270 degrees


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _relative(pi, pj):
    """Pose j in the frame of pose i, (x, y, theta) rows."""
    c, s = np.cos(pi[..., 2]), np.sin(pi[..., 2])
    dx, dy = pj[..., 0] - pi[..., 0], pj[..., 1] - pi[..., 1]
    return np.stack([c * dx + s * dy, -s * dx + c * dy, _wrap(pj[..., 2] - pi[..., 2])], axis=-1)


def _compose(pi, rel):
    c, s = np.cos(pi[2]), np.sin(pi[2])
    return np.array([pi[0] + c * rel[0] - s * rel[1], pi[1] + s * rel[0] + c * rel[1], _wrap(pi[2] + rel[2])])


def generate(poses: int = M3500_POSES, seed: int = 0) -> Dict[str, np.ndarray]:
    """Returns {"truth" (N, 3), "init" (N, 3), "edges" (E, 2) int,
    "meas" (E, 3), "info" (3, 3)}; odometry edges first, then the loop
    closures in order of their later pose."""
    rng = np.random.default_rng(seed)
    side = max(2, round(0.5 * math.sqrt(poses)))
    cell = np.array([side // 2, side // 2])
    start = cell.copy()
    heading = 0
    cells, headings = [cell.copy()], [heading]
    for _ in range(poses - 1):
        if rng.random() < TURN_PROB:
            heading = (heading + rng.choice([1, 3])) % 4
        inside = [h for h in range(4) if np.all((cell + _DIRS[h] >= 0) & (cell + _DIRS[h] < side))]
        if heading not in inside:
            turns = [h for h in inside if h != (heading + 2) % 4] or inside
            heading = int(rng.choice(turns))
        cell = cell + _DIRS[heading]
        cells.append(cell.copy())
        headings.append(heading)
    cells = np.asarray(cells)
    truth = np.concatenate([cells - start, (np.asarray(headings) * (np.pi / 2))[:, None]], axis=1).astype(float)
    truth[:, 2] = _wrap(truth[:, 2])

    visits: Dict[tuple, list] = {}
    loops = []
    for i, c in enumerate(map(tuple, cells)):
        loops += [(j, i) for j in visits.get(c, [])[-LINKS_PER_REVISIT:]]
        visits.setdefault(c, []).append(i)
    cap = round(poses * M3500_LOOP_CLOSURES / M3500_POSES)
    if len(loops) > cap:
        keep = np.sort(rng.choice(len(loops), size=cap, replace=False))
        loops = [loops[k] for k in keep]
    odo = [(i, i + 1) for i in range(poses - 1)]
    edges = np.asarray(odo + loops, dtype=np.int64).reshape(-1, 2)

    sigma = np.array([SIGMA_XY, SIGMA_XY, SIGMA_THETA])
    meas = _relative(truth[edges[:, 0]], truth[edges[:, 1]]) + sigma * rng.standard_normal((len(edges), 3))
    meas[:, 2] = _wrap(meas[:, 2])
    init = [truth[0]]
    for k in range(poses - 1):
        init.append(_compose(init[-1], meas[k]))
    return {"truth": truth, "init": np.asarray(init), "edges": edges, "meas": meas, "info": np.diag(1.0 / sigma**2)}


def write_g2o(path, graph: Dict[str, np.ndarray]) -> None:
    """VERTEX_SE2 id x y theta; EDGE_SE2 i j x y theta and the information
    matrix's upper triangle, row by row."""
    iu = np.triu_indices(3)
    info = " ".join(f"{v:.17g}" for v in graph["info"][iu])
    with open(path, "w") as f:
        for k, (x, y, t) in enumerate(graph["init"]):
            f.write(f"VERTEX_SE2 {k} {x:.17g} {y:.17g} {t:.17g}\n")
        for (i, j), (x, y, t) in zip(graph["edges"], graph["meas"]):
            f.write(f"EDGE_SE2 {i} {j} {x:.17g} {y:.17g} {t:.17g} {info}\n")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--poses", type=int, default=M3500_POSES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    graph = generate(a.poses, a.seed)
    write_g2o(a.out, graph)
    n_loops = len(graph["edges"]) - (a.poses - 1)
    print(f"{a.out}: {a.poses} poses, {len(graph['edges'])} edges ({a.poses - 1} odometry, {n_loops} loop closures)")


if __name__ == "__main__":
    main()
