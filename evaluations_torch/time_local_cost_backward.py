"""Local-cost backward micro-benchmark (the port of evaluations/time_local_cost_backward.py).

The smallest solve there is: LM, 3 iterations, one `Local(a, b)` cost on
SO3 or SE3 (default dense linearization), forward only, or forward and an
outer gradient step on the input through unroll backward (the reference
script's Adam-on-a-Parameter loop, here plain SGD at 1e-2). Per-step ms of
a 10-step loop, the minimum over 5 synced loops, each loop on inputs
salted by fresh_eps. At these shapes the arithmetic takes microseconds,
so the time is the port's per-solve dispatch floor on the card. No kernel
of the kernel table runs on this path (a Local cost has no kernel; the
dense system is solved by cholesky_ex). Runs on the card unless --device
cpu is given.

    python evaluations_torch/time_local_cost_backward.py [--batches 1 32 256 2048] [--groups SO3 SE3] [--device cpu]

Writes evaluations_torch/results_local_cost_backward.md.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from theseus_tpu_torch.lie import se3, so3

OUT = pathlib.Path(__file__).resolve().parent / "results_local_cost_backward.md"

DOF = {"SO3": 3, "SE3": 6}


def build(group, batch, dtype, device=None, tangents=None):
    """(layer, co, state, aux, a0): a = exp of one tangent draw, the target
    b = exp of another; the tangents (batch, dof) each from numpy seed 0 in
    order, or `tangents` = (ta, tb)."""
    mod = {"SO3": so3, "SE3": se3}[group]
    ctor = {"SO3": tt.SO3, "SE3": tt.SE3}[group]
    if tangents is None:
        rng = np.random.default_rng(0)
        tangents = [rng.standard_normal((batch, DOF[group])) for _ in range(2)]
    ta, tb = (torch.as_tensor(np.asarray(t), dtype=dtype, device=device) for t in tangents)
    a0, b0 = mod.exp(ta), mod.exp(tb)

    obj = tt.Objective(dtype=dtype, device=device)
    a = ctor(name="a")
    obj.add(tt.Local(a, tt.Variable(b0, name="b"), tt.ScaleCostWeight(1.0), name="d"))
    opt = tt.LevenbergMarquardt(obj, max_iterations=3, step_size=0.1, adaptive_damping=False, damping=0.1)
    layer = tt.TheseusLayer(opt)
    co = obj.compile()
    values = obj.default_values({"a": a0})
    return layer, co, co.pack(values, batch), co.build_aux(values, batch), a0


def stepper(layer, state, aux, key, backward):
    """step(a_in, eps) -> (next a_in, value): the forward solve from the
    input scaled by 1 + eps (value: its final error), or also its unroll
    gradient of sum(err) with respect to the input and an SGD step (value:
    the loss)."""
    opts = layer.optimizer.opts

    def solve(a_in, eps):
        st = dict(state)
        st[key] = a_in * (1.0 + eps)
        return layer.solve_state(st, aux, "unroll", opts)["err"]

    if not backward:
        def step(a_in, eps):
            with torch.no_grad():
                return a_in, solve(a_in, eps)
        return step

    def step(a_in, eps):
        a_in = a_in.detach().requires_grad_(True)
        loss = torch.sum(solve(a_in, eps))
        (g,) = torch.autograd.grad(loss, [a_in])
        return (a_in - 0.01 * g).detach(), loss.detach()

    return step


def run_case(group, batch, backward, device, dtype=torch.float32, reps=5, steps=10):
    """Per-step ms of a 10-step loop (forward solves, or forward and
    backward steps carrying the input)."""
    layer, co, state, aux, _ = build(group, batch, dtype, device)
    step = stepper(layer, state, aux, group, backward)

    def loop(eps):
        a_in = state[group]
        for i in range(steps):
            a_in, v = step(a_in, eps + i * 1e-12)  # no two steps on the same inputs
        return v

    loop(0.0)  # warm-up
    return min(_common.synced_s(lambda: loop(_common.fresh_eps(i)), device)[1] for i in range(reps)) / steps * 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[1, 32, 256, 2048])
    p.add_argument("--groups", nargs="+", default=["SO3", "SE3"])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)

    rows = []
    for group in a.groups:
        for batch in a.batches:
            f = run_case(group, batch, False, dev)
            b = run_case(group, batch, True, dev)
            rows.append((group, batch, f, b))
            print(f"{group} b={batch:5d}: fwd {f:8.3f} ms  fwd+bwd {b:8.3f} ms", flush=True)

    notes = (f"On {dev.type}, float32. LM 3 iterations (step 0.1, damping 0.1) on one Local(a, b) cost, dense "
             "linearization. Per-step ms of a 10-step loop, the minimum of 5 synced loops; fwd+bwd adds an outer "
             "gradient step on the input through unroll backward. At these shapes the time is the per-solve "
             "dispatch cost; no kernel of the kernel table runs on this path.")
    _common.write_results(
        OUT, "Local-cost backward micro-benchmark, theseus_tpu_torch",
        [_common.Section(f"local cost ({dev.type})", notes, ["group", "batch", "forward ms/step", "fwd+bwd ms/step"],
                         [[g, str(b), f"{f:.3f}", f"{bb:.3f}"] for g, b, f, bb in rows], n_key=2)],
        card, sort_key=lambda r: (r[0] != "SO3", int(r[1])))
    return rows


if __name__ == "__main__":
    main()
