"""Tiny sizes of each cell for the CPU tests: the cells' own code paths at
a size a test run holds."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {
    "pgo_sphere2500.solve_b64": ({"layout": {"kind": "snake_grid", "rows": 4, "cols": 5}, "n_poses": 20, "n_edges": 31}, {"batch": 4}),
    "pgo_sphere2500.train_b64": ({"layout": {"kind": "snake_grid", "rows": 4, "cols": 5}, "n_poses": 20, "n_edges": 31}, {"batch": 4}),
}
SEED = 2**31 + 11


def run_tiny(cell, trace=0, fault=None, seed=SEED, dtype=None):
    from portbench import run

    cfg, traffic = TINY[cell]
    cfg = dict(cfg, **({"dtype": dtype} if dtype else {}))
    return run.run_cell(SPEC, cell, seed, 0.2, trace, device="cpu", cfg_override=cfg, traffic_override=traffic,
                        fault=fault, t0=0.0)


def tiny_problem(cell, seed=SEED, dtype="float64"):
    from portbench import run

    cfg, traffic = TINY[cell]
    c = run.Cell(SPEC, cell, dict(cfg, dtype=dtype), traffic)
    return c.problem(seed, "cpu")
