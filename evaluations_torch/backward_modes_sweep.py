"""Backward-mode cost and accuracy sweep (the port of evaluations/backward_modes_sweep.py, the Theseus paper's Fig. 4 on PGO).

The inner problem is a batched SE3 pose graph whose loop-closure weight
w_loop (against the odometry weight w_odo = 1) is the outer parameter
theta; the outer loss is the squared distance of the Gauss-Newton solution
(default dense linearization: the Between kernel gives the jacobian) to
ground truth. For unroll, implicit, truncated(2 / 4 / 8) and dlm, the
gradient d loss / d theta by `torch.autograd.grad` through
`TheseusLayer.solve_state`, held against the central difference of the
implicit-mode loss, with ms per gradient (the minimum of 5 synced calls)
and the first call's seconds.

Precision: float64 with h = 1e-4 isolates mode error; on the card the
sweep runs again in float32 with h = 5e-3, the JAX script's accelerator
tier. On the CPU only float64 runs. A mode that runs out of device memory
is recorded as failed; any other error raises. Runs on the card
unless --device cpu is given.

    python evaluations_torch/backward_modes_sweep.py [--n-poses 16 --batch 4] [--inner-iters 10] [--append] [--device cpu]

Writes evaluations_torch/results_backward_modes.md (--append keeps the
sections already there).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.pose_graph import (
    build_pgo_objective,
    pose_values,
    synthetic_pose_graph,
    training_weights,
)

OUT = pathlib.Path(__file__).resolve().parent / "results_backward_modes.md"

MODES = [("unroll", None), ("implicit", None), ("truncated", 2), ("truncated", 4), ("truncated", 8), ("dlm", None)]
FD_STEP = {torch.float64: 1e-4, torch.float32: 5e-3}
THETA = 0.3
NOTE = ("Reading 'rel err vs FD': the FD baseline itself carries O(h^2) + roundoff/h error at the run's "
        "dtype. At float32 with h = 5e-3 that floor is ~2e-2: a ~2e-2 entry there measures FD noise, not "
        "mode error. The float64 tier (h = 1e-4, floor ~1e-8) is the one that isolates mode error.")


def build(n_poses, batch, inner_iters, dtype=torch.float64, device=None, graph=None):
    """(layer, co, obj, values, state, gt_state, batch): the objective with
    two edge classes, odometry (weight w_odo = 1) and loop closures (the
    named weight w_loop), so that theta moves the inner solution (a uniform
    scale of every weight would leave it where it is). synthetic_pose_graph
    seed 0, or `graph` = (gt, edges, measurements, init)."""
    gt, edges, meas, init = graph if graph is not None else synthetic_pose_graph(
        n_poses=n_poses, batch=batch, seed=0, dtype=dtype, device=device)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(n_poses, edges, meas, gt[0], dtype=dtype, device=device, edge_weight=w_odo,
                                 loop_weight=w_loop)
    layer = tt.TheseusLayer(tt.GaussNewton(obj, max_iterations=inner_iters))
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    state = co.pack(values, batch)
    gt_state = co.pack(obj.default_values(pose_values(gt)), batch)
    return layer, co, obj, values, state, gt_state, batch


def make_outer_loss(layer, co, obj, values, state, gt_state, batch, mode, bwd_iters):
    """loss(theta): the summed squared distance of the inner solution to
    ground truth, theta the loop-closure weight (a 0-d tensor)."""
    opts = layer.optimizer.opts

    def loss(theta):
        vals = dict(values)
        vals["w_loop"] = theta.reshape(1, 1)  # the (1, 1) weight, theta everywhere
        aux = co.build_aux(vals, batch)
        sol = layer.solve_state(state, aux, mode, opts, bwd_iters)["state"]
        return sum(torch.sum((sol[k] - gt_state[k]) ** 2) for k in sol)

    return loss


def gradient(loss, theta, dtype, device):
    """d loss / d theta at the float theta."""
    th = torch.tensor(theta, dtype=dtype, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(loss(th), [th])
    return g


def fd_gradient(parts, theta, h, dtype, device):
    """Central difference of the implicit-mode loss (its forward is the
    mode-independent solve)."""
    f = make_outer_loss(*parts, "implicit", 4)
    with torch.no_grad():
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
        return (f(t(theta + h)) - f(t(theta - h))) / (2 * h)


def timed_gradient(loss, dtype, device, reps=5):
    """(gradient, ms/grad: the minimum of `reps` synced calls, first call s)."""
    g, first_s = _common.synced_s(lambda: float(gradient(loss, THETA, dtype, device)), device)
    ms = min(_common.synced_s(lambda: gradient(loss, THETA, dtype, device), device)[1] for _ in range(reps)) * 1e3
    return g, ms, first_s


def sweep(n_poses, batch, inner_iters, dtype, device):
    """(fd, rows): rows of (label, gradient, rel err vs FD, ms/grad, first
    call s), or (label, "failed (OutOfMemoryError)") for a mode that ran out
    of device memory."""
    parts = build(n_poses, batch, inner_iters, dtype, device)
    fd = float(fd_gradient(parts, THETA, FD_STEP[dtype], dtype, device))
    print(f"FD reference grad ({config.dtype_name(dtype)}): {fd:+.8f}")
    rows = []
    for mode, k in MODES:
        label = mode + (f"({k})" if k else "")
        loss = make_outer_loss(*parts, mode, k or 4)
        r, failed = _common.or_out_of_memory(lambda: timed_gradient(loss, dtype, device), label)
        if failed:
            rows.append((label, failed))
            continue
        g, ms, first_s = r
        rel = abs(g - fd) / max(abs(fd), 1e-12)
        rows.append((label, g, rel, ms, first_s))
        print(f"{label:14s} grad {g:+.8f}  rel-err {rel:.2e}  {ms:8.2f} ms/grad (first call {first_s:.2f} s)",
              flush=True)
    return fd, rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-poses", type=int, default=16)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--inner-iters", type=int, default=10)
    p.add_argument("--append", action="store_true", help="keep the sections already in the file")
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)
    dtypes = [torch.float64] + ([torch.float32] if dev.type == "cuda" else [])

    sections, results = [], {}
    for dtype in dtypes:
        dn = config.dtype_name(dtype)
        heading = (f"PGO SE3 {a.n_poses} poses, batch {a.batch}, {a.inner_iters} inner GN iters, {dev.type}, "
                   f"{dn}, FD h={FD_STEP[dtype]:g}")
        cols = ["mode", "gradient", "rel err vs FD", "ms/grad", "first call (s)"]
        fd, rows = sweep(a.n_poses, a.batch, a.inner_iters, dtype, dev)
        results[dtype] = {"fd": fd, "rows": rows}
        sections.append(_common.Section(
            heading, f"FD reference gradient: {fd:+.8f}", cols,
            [[r[0], r[1], "-", "-", "-"] if len(r) == 2 else
             [r[0], f"{r[1]:+.8f}", f"{r[2]:.2e}", f"{r[3]:.2f}", f"{r[4]:.2f}"] for r in rows]))
    _common.write_results(OUT, "Backward-mode sweep, theseus_tpu_torch", sections, card, preamble=NOTE,
                          fresh=not a.append)
    return results


if __name__ == "__main__":
    main()
