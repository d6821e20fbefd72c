"""GBP convergence evaluation (the port of evaluations/gbp_eval.py).

Loopy SE2 pose graphs (a chain and 4 random loop closures, numpy seed 0):
the relative L2 error of the Gaussian-belief-propagation step
(`GBPNormalBuilder`) against the direct Gauss-Newton step
(`DenseNormalBuilder`) after 10, 40 and 160 synchronous sweeps, at message
damping 0 and 0.3; and the final error of GBP as the nonlinear solver (40
sweeps, damping 0.3, 15 outer iterations) against Gauss-Newton's. Float64:
this measures algorithmic convergence. Runs on the card unless --device
cpu is given.

    python evaluations_torch/gbp_eval.py [--device cpu]

Writes its two sections of evaluations_torch/results_gbp.md (the section
of gbp_hw_bench.py stays).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from theseus_tpu_torch.lie import se2
from theseus_tpu_torch.optim.gbp import GBPNormalBuilder
from theseus_tpu_torch.optim.normal import DenseNormalBuilder

OUT = pathlib.Path(__file__).resolve().parent / "results_gbp.md"

SIZES = (16, 64, 256)
SWEEP_GRID = (10, 40, 160)
TITLE = "GBP evaluation, theseus_tpu_torch"


def build(n, batch=1, seed=0, closures=4, device=None):
    """The loopy SE2 graph of the JAX script, from the same numpy draws: a
    random walk of ground-truth poses, noisy initial poses, a prior on pose
    0 (weight 10), the chain and `closures` random loop closures."""
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    gt_t, cur = [], np.zeros((batch, 3))
    for _ in range(n):
        gt_t.append(cur.copy())
        cur = cur + rng.normal(scale=0.4, size=(batch, 3))
    t = lambda a: torch.as_tensor(a, dtype=f64, device=device)  # noqa: E731
    gt = [se2.exp(t(g)) for g in gt_t]
    obj = tt.Objective(dtype=f64, device=device)
    poses = [tt.SE2(tensor=se2.exp(t(gt_t[i] + rng.normal(scale=0.15, size=(batch, 3)))), name=f"x{i}")
             for i in range(n)]
    obj.add(tt.Difference(poses[0], tt.SE2(tensor=gt[0], name="pt"), tt.ScaleCostWeight(10.0), name="prior"))
    edges = [(i, i + 1) for i in range(n - 1)]
    for _ in range(closures):
        i = int(rng.integers(0, n - 2))
        j = int(rng.integers(i + 1, n))
        edges.append((i, j))
    for (i, j) in set(edges):
        meas = se2.compose(se2.inverse(gt[i]), gt[j])
        obj.add(tt.Between(poses[i], poses[j], tt.SE2(tensor=meas, name=f"m{i}_{j}"), tt.ScaleCostWeight(1.0),
                           name=f"e{i}_{j}"))
    return obj


def step_quality(obj, damping, sweep_grid=SWEEP_GRID):
    """Relative L2 error of the GBP step against the direct GN step, one a
    sweep count."""
    co = obj.compile()
    values = obj.default_values()
    b = co.resolve_batch_size(values)
    state, aux = co.pack(values, b), co.build_aux(values, b)
    d_ref, _ = DenseNormalBuilder(co).build(state, aux).solve(0.0, False)
    ref_norm = float(torch.linalg.norm(d_ref))
    rels = []
    for sweeps in sweep_grid:
        bld = GBPNormalBuilder(co, msg_iters=sweeps, msg_damping=damping, ridge=1e-12)
        d, _ = bld.build(state, aux).solve(0.0, False)
        rels.append(float(torch.linalg.norm(d - d_ref)) / ref_norm)
    return rels


def outer_convergence(obj, sweeps=40, damping=0.3, iters=15):
    """(GBP final error, GN final error): inexact steps still reach the
    optimum (the inexact-Newton argument)."""
    gbp = tt.GaussianBeliefPropagation(obj, max_iterations=iters, msg_iters=sweeps, msg_damping=damping)
    _, info_g = gbp.optimize()
    gn = tt.GaussNewton(obj, max_iterations=iters)
    _, info_n = gn.optimize()
    return float(torch.max(info_g.last_err)), float(torch.max(info_n.last_err))


def main(argv=None, sizes=SIZES):
    """`sizes`: the graph sizes (a caller's cut; the command line runs all)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)

    step_rows, outer_rows = [], []
    for n in sizes:
        obj = build(n, device=dev)
        for damping in (0.0, 0.3):
            rels = step_quality(obj, damping)
            step_rows.append((n, damping, rels))
            print(f"n={n} damping={damping}: rel err vs GN step @10/40/160 sweeps = "
                  + "/".join(f"{r:.1e}" for r in rels), flush=True)
        eg, en = outer_convergence(obj)
        outer_rows.append((n, eg, en))
        print(f"n={n}: outer final err GBP={eg:.2e} GN={en:.2e}", flush=True)

    step = _common.Section(
        "Linear step quality",
        f"Loopy SE2 PGO, 4 random loop closures, float64, on {dev.type}. Relative L2 error of the GBP step "
        "against the direct Gauss-Newton step. Each sweep is one batched step over all factors whatever the "
        "graph's size; information travels about one edge a sweep.",
        ["poses", "msg damping", "10 sweeps", "40", "160"],
        [[str(n), str(d), *(f"{r:.1e}" for r in rels)] for n, d, rels in step_rows], n_key=2)
    outer = _common.Section(
        "Nonlinear (outer) convergence",
        "GBP is an inexact step inside the relinearize loop: a step error of a few percent does not keep it "
        "from the optimum GN reaches (inexact-Newton behaviour).",
        ["poses", "GBP(40 sweeps, damping .3) final err", "GN final err"],
        [[str(n), f"{eg:.2e}", f"{en:.2e}"] for n, eg, en in outer_rows], n_key=1)
    _common.write_results(OUT, TITLE, [step, outer], card)
    return {"step": step_rows, "outer": outer_rows}


if __name__ == "__main__":
    main()
