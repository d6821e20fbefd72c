"""Vectorization ablation (the port of evaluations/vectorization_ablation.py, the Theseus paper's Fig. 3).

Marginal ms per LM iteration of batched SE3 pose-graph optimization on the
sparse linearization (level plan), with the costs compiled into schema
buckets (`Objective.compile(vectorize=True)`) or one bucket per cost
(`vectorize=False`), and the kernels of the table on or off:

- "off": vectorize=False, the plain PyTorch twins (`config.plain_path()`);
- "on": vectorize=True, the twins;
- "on+kernels": vectorize=True, the CUDA kernels (Between, assembly, level
  factorization and both level substitutions).

The window is (t(2 + 32 iterations) - t(2)) / 32, each solve synced at its
end, on inputs salted by fresh_eps. "first call (s)" is the objective's
build and the first 10-iteration solve together: the port compiles
nothing (the CUDA kernels are built once, before the first cell), so it
stands where the JAX table's compile seconds stand. A cell that runs out of device
memory is recorded as failed; any other error raises. Runs on the card
unless --device cpu is given.

    python evaluations_torch/vectorization_ablation.py [--sizes 16,64,256,512] [--batch 16] [--combos off,on,on+kernels] [--device cpu]

Writes evaluations_torch/results_vectorization.md (rows of other sizes
already there stay).
"""

import argparse
import contextlib
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

OUT = pathlib.Path(__file__).resolve().parent / "results_vectorization.md"

# name: (vectorize, kernels)
ALL_COMBOS = {"off": (False, False), "on": (True, False), "on+kernels": (True, True)}
FIRST_ITERS = 10
WINDOW = (2, 32)  # (base, extra) LM iterations of the marginal window


def build(n_poses, batch, vectorize, dtype=torch.float32, device=None, graph=None):
    """(layer, state, aux) of PGO n_poses x batch (synthetic_pose_graph seed
    0, or `graph` = (gt, edges, measurements, init)), LM with adaptive
    damping on the sparse linearization, compiled with `vectorize`."""
    gt, edges, meas, init = graph if graph is not None else synthetic_pose_graph(
        n_poses=n_poses, batch=batch, seed=0, dtype=dtype, device=device)
    obj, _ = build_pgo_objective(n_poses, edges, meas, gt[0], dtype=dtype, device=device)
    opt = tt.LevenbergMarquardt(obj, max_iterations=FIRST_ITERS, adaptive_damping=True, linearization="sparse")
    layer = tt.TheseusLayer(opt, vectorize=vectorize)
    co = obj.compile(vectorize=vectorize)
    values = obj.default_values(pose_values(init))
    return layer, co.pack(values, batch), co.build_aux(values, batch)


def lm_solver(layer, state, aux):
    """solve(n, eps): n LM iterations from the state scaled by 1 + eps; the
    final error (B,)."""
    opt = layer.optimizer

    def solve(n, eps=0.0):
        with torch.no_grad():
            st = {k: v * (1.0 + eps) for k, v in state.items()}
            carry = opt.init_carry(st, aux, opt.opts)
            return opt.run_scan(carry, aux, n, opt.opts)["err"]

    return solve


def per_iter_ms(layer, state, aux, device):
    """Marginal ms per LM iteration over `WINDOW` (the JAX script's
    32-iteration window)."""
    return _common.marginal_ms(lm_solver(layer, state, aux), *WINDOW, device)


def run_cell(n_poses, batch, vectorize, kernels, device, dtype=torch.float32):
    """{"ms", "first_s", "err"}: the marginal ms, the seconds of the build
    and the first 10-iteration solve, and that solve's final error (B,)."""
    with contextlib.nullcontext() if kernels else config.plain_path():
        t0 = time.perf_counter()
        layer, state, aux = build(n_poses, batch, vectorize, dtype, device)
        err, _ = _common.synced_s(lambda: lm_solver(layer, state, aux)(FIRST_ITERS), device)
        first_s = time.perf_counter() - t0
        ms = per_iter_ms(layer, state, aux, device)
    return {"ms": ms, "first_s": first_s, "err": err.detach().cpu()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="16,64")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--combos", default=None,
                   help="comma list of off,on,on+kernels (default all); lets the vectorized rows land "
                        "without waiting for the unvectorized ones at large sizes")
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)
    sizes = [int(s) for s in a.sizes.split(",")]
    combos = a.combos.split(",") if a.combos else list(ALL_COMBOS)

    rows, results = [], []
    for n_poses in sizes:
        for name in combos:
            vec, kernels = ALL_COMBOS[name]
            r, failed = _common.or_out_of_memory(lambda: run_cell(n_poses, a.batch, vec, kernels, dev),
                                                 f"poses={n_poses} vectorize={vec} kernels={kernels}")
            if failed:
                rows.append([str(n_poses), str(vec), str(kernels), failed, "-"])
                continue
            results.append(dict(r, poses=n_poses, vectorize=vec, kernels=kernels))
            rows.append([str(n_poses), str(vec), str(kernels), f"{r['ms']:.2f}", f"{r['first_s']:.1f}"])
            print(f"poses={n_poses:4d} vectorize={vec!s:5s} kernels={kernels!s:5s}: {r['ms']:8.2f} ms/iter "
                  f"(first call {r['first_s']:.1f} s, final error mean {float(r['err'].mean()):.6e})", flush=True)
            _write(rows, a.batch, card)  # incremental: a killed run keeps its cells
    _write(rows, a.batch, card)
    return results


def _write(rows, batch, card):
    notes = (f"Batch {batch}, float32, LM with adaptive damping on the sparse linearization (level plan). "
             "ms/LM-iter: (t(34 iterations) - t(2)) / 32, each solve synced at its end, inputs salted by "
             "fresh_eps, the minimum of 3 calls of each length. kernels False: every kernel wrapper runs its "
             "plain PyTorch twin on the card (config.plain_path()). first call (s): the objective's build and "
             "the first 10-iteration solve (the port compiles nothing; the CUDA kernels are built before).")
    _common.write_results(
        OUT, "Vectorization ablation (PGO SE3), theseus_tpu_torch",
        [_common.Section(f"batch {batch}", notes, ["poses", "vectorize", "kernels", "ms/LM-iter", "first call (s)"],
                         rows, n_key=3)],
        card, sort_key=lambda r: (int(r[0]), r[1], r[2]))


if __name__ == "__main__":
    main()
