"""GBP timing on the card (the port of evaluations/gbp_hw_bench.py).

On batched SE3 pose graphs (PGO 64 x 16 and 256 x 128, float32): the
marginal ms of one GBP message sweep, (t(40 sweeps) - t(10 sweeps)) / 30
inside a fixed 4-outer-iteration solve, divided by the 4 outer iterations;
the marginal ms of one GBP outer iteration at 10 sweeps, (t(12) - t(4)) /
8; and the same for sparse LM (adaptive damping, level plan). Each solve
is synced at its end, on inputs salted by fresh_eps, the minimum of 3.
GBP's linearization runs the Between kernel; LM's runs it and the
assembly, level factorization and substitution kernels. Runs on the card
unless --device cpu is given.

    python evaluations_torch/gbp_hw_bench.py [--device cpu]

Writes its section of evaluations_torch/results_gbp.md (gbp_eval.py's
sections stay).
"""

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from evaluations_torch.gbp_eval import OUT, TITLE
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

SHAPES = ((64, 16), (256, 128))


def build(n_poses, batch, optimizer="gbp", msg_iters=10, dtype=torch.float32, device=None):
    """(layer, state, aux) of PGO n_poses x batch (synthetic_pose_graph seed
    0) under GBP (`msg_iters` sweeps an outer iteration) or sparse LM."""
    gt, edges, meas, init = synthetic_pose_graph(n_poses=n_poses, batch=batch, seed=0, dtype=dtype, device=device)
    obj, _ = build_pgo_objective(n_poses, edges, meas, gt[0], dtype=dtype, device=device)
    if optimizer == "gbp":
        opt = tt.GaussianBeliefPropagation(obj, msg_iters=msg_iters, max_iterations=10)
    else:
        opt = tt.LevenbergMarquardt(obj, max_iterations=10, adaptive_damping=True, linearization="sparse")
    layer = tt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    return layer, co.pack(values, batch), co.build_aux(values, batch)


def solver(layer, state, aux, opts):
    """solve(n, eps): n outer iterations under `opts` from the state scaled
    by 1 + eps; the final error (B,)."""
    opt = layer.optimizer

    def solve(n, eps=0.0):
        with torch.no_grad():
            st = {k: v * (1.0 + eps) for k, v in state.items()}
            return opt.run_scan(opt.init_carry(st, aux, opts), aux, n, opts)["err"]

    return solve


def time_solve(layer, state, aux, opts, n_outer, device, reps=3):
    """Seconds of one n_outer-iteration solve, the minimum of `reps` after a
    warm-up."""
    solve = solver(layer, state, aux, opts)
    _common.synced_s(lambda: solve(n_outer), device)
    return min(_common.synced_s(lambda: solve(n_outer, _common.fresh_eps(i)), device)[1] for i in range(reps))


def measure(n_poses, batch, device):
    """(ms/sweep, GBP ms/outer iteration at 10 sweeps, LM ms/iteration)."""
    layer, state, aux = build(n_poses, batch, "gbp", device=device)
    o10 = dataclasses.replace(layer.optimizer.opts, msg_iters=10)
    o40 = dataclasses.replace(layer.optimizer.opts, msg_iters=40)
    t10 = time_solve(layer, state, aux, o10, 4, device)
    t40 = time_solve(layer, state, aux, o40, 4, device)
    ms_sweep = (t40 - t10) / (30 * 4) * 1e3
    ms_outer_gbp = (time_solve(layer, state, aux, o10, 12, device)
                    - time_solve(layer, state, aux, o10, 4, device)) / 8 * 1e3
    layer2, state2, aux2 = build(n_poses, batch, "lm", device=device)
    o = layer2.optimizer.opts
    ms_lm = (time_solve(layer2, state2, aux2, o, 12, device) - time_solve(layer2, state2, aux2, o, 4, device)) / 8 * 1e3
    return ms_sweep, ms_outer_gbp, ms_lm


def main(argv=None, shapes=SHAPES):
    """`shapes`: the (poses, batch) cells (a caller's cut; the command line
    runs all)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)

    rows = []
    for n_poses, batch in shapes:
        s, og, lm = measure(n_poses, batch, dev)
        rows.append((n_poses, batch, s, og, lm))
        print(f"poses={n_poses} batch={batch}: {s:.3f} ms/sweep ({1e3 / s:.0f} sweeps/s), GBP outer {og:.2f} ms "
              f"(10 sweeps), direct LM {lm:.2f} ms/iter", flush=True)

    notes = (f"On {dev.type}, float32, batched SE3 PGO (synthetic_pose_graph seed 0). ms/sweep: (t(40 sweeps) - "
             "t(10 sweeps)) / 30 inside a fixed 4-outer-iteration solve, per outer iteration; GBP ms/outer-iter: "
             "(t(12) - t(4)) / 8 at 10 sweeps; direct LM: the same window for sparse LM (level plan). Each solve "
             "synced at its end, inputs salted by fresh_eps, the minimum of 3.")
    _common.write_results(
        OUT, TITLE,
        [_common.Section(f"On-hardware timing ({dev.type}, float32, batched SE3 PGO)", notes,
                         ["poses", "batch", "ms/sweep", "sweeps/s", "GBP ms/outer-iter (10 sweeps)",
                          "direct LM ms/iter", "GBP/LM cost ratio"],
                         [[str(n), str(b), f"{s:.3f}", f"{1e3 / s:.0f}", f"{og:.2f}", f"{lm:.2f}", f"{og / lm:.1f}x"]
                          for n, b, s, og, lm in rows], n_key=2)],
        card, sort_key=lambda r: (int(r[0]), int(r[1])))
    return rows


if __name__ == "__main__":
    main()
