"""The program's spans (theseus_tpu_torch/tracing.py), on the CPU.

Off, `span` hands back one shared no-op and never makes a profiler event;
under torch.profiler every layer boundary of a sparse or dense solve, and
of an implicit training step's backward, shows up as a function-scoped
event nested as the call nests. Every profiler starts inside a test.
"""

import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import theseus_tpu_torch as tt
from theseus_tpu_torch import tracing
from theseus_tpu_torch.utils.examples.pose_graph import (
    build_pgo_objective,
    mean_sq_local,
    pose_values,
    synthetic_pose_graph,
    training_weights,
)

PKG = Path(tt.__file__).resolve().parent
N, B, ITERS = 8, 2, 3
# what a sparse forward in the default (unroll) mode records
SOLVE_PATH = ("tt.forward", "tt.pack", "tt.unpack", "tt.lm.init", "tt.lm.iteration", "tt.linearize",
              "tt.assemble", "tt.solve", "tt.factor", "tt.subst")


def _layer(linearization="sparse", train=False):
    """(layer, inputs, gt); `train`: the inputs hold the loop-closure weight
    and the first edge's measurement, both requiring grad, so that the
    implicit backward runs the solve's, the assembly's and the Between
    twin's VJPs."""
    gt, edges, meas, init = synthetic_pose_graph(n_poses=N, batch=B, seed=0, dtype=torch.float64, device="cpu")
    kw = dict(zip(("edge_weight", "loop_weight"), training_weights())) if train else {}
    obj, _ = build_pgo_objective(N, edges, meas, gt[0], dtype=torch.float64, device="cpu", **kw)
    opt = tt.LevenbergMarquardt(obj, max_iterations=ITERS, linearization=linearization, adaptive_damping=True)
    inputs = pose_values(init)
    if train:
        inputs["w_loop"] = torch.tensor([[0.5]], dtype=torch.float64, requires_grad=True)
        inputs[obj.get_cost_function("edge_0").aux_vars[0].name] = meas[0].clone().requires_grad_(True)
    return tt.TheseusLayer(opt), inputs, gt


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, [e for e in prof.events() if e.name.startswith("tt.")]


def _inside(inner, outer):
    return outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end


def test_span_off_is_the_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler event for {name} with no profiler running")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    for name in tracing.SPANS:
        assert tracing.span(name) is tracing._OFF
    layer, inputs, _ = _layer()
    with torch.no_grad():
        out, info = layer.forward(inputs)
    assert torch.isfinite(info.last_err).all()


def test_span_sites_are_the_listed_spans():
    sites = set()
    for path in PKG.rglob("*.py"):
        sites |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert sites == set(tracing.SPANS)
    assert len(tracing.SPANS) == len(set(tracing.SPANS))
    assert all(n.startswith("tt.") for n in tracing.SPANS)


@pytest.mark.parametrize("linearization", ["sparse", "dense"])
def test_forward_records_each_layer(linearization):
    layer, inputs, _ = _layer(linearization)
    with torch.no_grad():
        (out, info), events = _profiled(lambda: layer.forward(inputs))
    names = [e.name for e in events]
    by = {n: [e for e in events if e.name == n] for n in set(names)}
    assert len(by["tt.forward"]) == 1
    # the iterations run: the error history's rows past the first
    hist = info.err_history
    assert len(by["tt.lm.iteration"]) == int(torch.isfinite(hist).all(dim=1).sum()) - 1 == ITERS
    for n in ("tt.linearize", "tt.assemble", "tt.solve"):
        assert len(by[n]) == ITERS
    if linearization == "dense":
        assert "tt.factor" not in by and "tt.subst" not in by
        assert set(names) == set(SOLVE_PATH) - {"tt.factor", "tt.subst"}
        return
    assert set(names) == set(SOLVE_PATH)
    fwd = by["tt.forward"][0]
    for n in ("tt.factor", "tt.subst"):
        assert len(by[n]) == ITERS
        for e in by[n]:
            it = [s for s in by["tt.lm.iteration"] if _inside(e, s)]
            assert len(it) == 1 and _inside(it[0], fwd)
    for n in ("tt.pack", "tt.unpack", "tt.lm.init"):
        assert all(_inside(e, fwd) for e in by[n])


def test_implicit_training_step_records_the_backward():
    layer, inputs, gt = _layer("sparse", train=True)
    leaves = [t for t in inputs.values() if t.requires_grad]

    def step():
        out, info = layer.forward(inputs, optimizer_kwargs={"backward_mode": "implicit"})
        mean_sq_local(out, gt).backward()
        return info

    info, events = _profiled(step)
    names = {e.name for e in events}
    assert {"tt.implicit_step", "tt.backward.solve", "tt.backward.assemble", "tt.backward.vjp",
            "tt.lm.sync"} <= names
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    # the early-exit loop: one sync before each iteration it runs
    run = int(torch.isfinite(info.err_history).all(dim=1).sum()) - 1
    assert sum(e.name == "tt.lm.iteration" for e in events) == run
    assert sum(e.name == "tt.lm.sync" for e in events) >= run
    (step_span,) = [e for e in events if e.name == "tt.implicit_step"]
    assert any(e.name == "tt.factor" and _inside(e, step_span) for e in events)


def test_no_span_is_a_user_annotation():
    layer, inputs, _ = _layer()
    with torch.no_grad():
        _, events = _profiled(lambda: layer.forward(inputs))
    assert events
    assert not any(e.is_user_annotation for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)
