"""The idle split by program spans (spans.py) on hand-made traces."""

import json
from types import SimpleNamespace

import pytest

from _tiny import ROOT, SPEC, run_tiny
from portbench import run
from portbench.spans import LAYERS, idle_by_span, idle_pct, innermost
from portbench.trace_reduce import Span, busy_seconds

IDLE = [m["name"] for m in SPEC["per_layer"] if m["name"].startswith("idle_")]


def _ctx(dev, host, window_us, kind="solve"):
    return SimpleNamespace(kind=kind, dev=dev, host=host, busy_s=busy_seconds(dev), window_s=window_us * 1e-6)


def _reader(name):
    return run.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))


# a call 0..100 us: the forward holds two iterations, each a factor; the
# device runs 10..20, 45..50 and 70..75
HOST = [Span("tt.forward", 0, 100), Span("tt.lm.iteration", 5, 50), Span("tt.factor", 30, 40),
        Span("tt.lm.iteration", 50, 90), Span("tt.factor", 60, 80), Span("aten::add", 32, 35)]
DEV = [Span("k", 10, 20), Span("k", 45, 50), Span("k", 70, 75)]


def test_the_innermost_span_wins():
    assert innermost(HOST[:5]) == [
        (0, 5, "tt.forward"), (5, 30, "tt.lm.iteration"), (30, 40, "tt.factor"), (40, 50, "tt.lm.iteration"),
        (50, 60, "tt.lm.iteration"), (60, 80, "tt.factor"), (80, 90, "tt.lm.iteration"), (90, 100, "tt.forward")]
    # of two spans that start together, the shorter is inside the longer
    assert innermost([Span("tt.a", 0, 10), Span("tt.b", 0, 4)]) == [(0, 4, "tt.b"), (4, 10, "tt.a")]


def test_a_gap_across_span_boundaries_is_split_exactly():
    by = idle_by_span(DEV, HOST)
    # 0..10 forward 5, iteration 5; 20..45 iteration 10 + 5, factor 10;
    # 50..70 iteration 10, factor 10; 75..100 factor 5, iteration 10, forward 10
    want = {"tt.forward": 15, "tt.lm.iteration": 40, "tt.factor": 25}
    assert set(by) == set(want)
    for name, us in want.items():
        assert by[name] == pytest.approx(us * 1e-6, abs=1e-15)


def test_idle_where_no_span_covers_is_outside():
    host = [Span("aten::empty", 0, 100), Span("tt.forward", 20, 60)]
    by = idle_by_span([Span("k", 30, 40)], host)
    assert by == pytest.approx({"outside": 60e-6, "tt.forward": 30e-6})
    # only spans under the prefix count
    host = [Span("tt.backward.solve", 0, 50), Span("tt.subst", 10, 20)]
    assert idle_by_span([], host, prefix="tt.subst") == pytest.approx({"outside": 40e-6, "tt.subst": 10e-6})


def test_a_span_inside_the_backward_counts_as_backward():
    # the solve's VJP runs the substitutions: its sweeps are backward time,
    # while a forward substitution before it stays `tt.subst`
    host = [Span("tt.subst", 0, 10), Span("tt.backward.solve", 20, 70), Span("tt.subst", 30, 40),
            Span("tt.factor", 35, 38), Span("tt.backward.assemble", 80, 90)]
    assert idle_by_span([], host) == pytest.approx(
        {"tt.subst": 10e-6, "outside": 20e-6, "tt.backward.solve": 50e-6, "tt.backward.assemble": 10e-6})
    # the plain innermost rule would give the sweeps to `tt.subst`
    assert (30, 35, "tt.subst") in innermost(host)


def _step(kind="train"):
    """A call's host events (0..200 us) and device operations; a training
    step's hold the implicit step and the backward."""
    host = HOST + [Span("cudaDeviceSynchronize", 100, 130), Span("tt.lm.sync", 110, 112),
                   Span("tt.implicit_step", 130, 150), Span("tt.subst", 140, 145), Span("aten::mul", 195, 200)]
    if kind == "train":
        host += [Span("tt.backward.solve", 160, 190), Span("tt.subst", 165, 175)]
    dev = DEV + [Span("k", 95, 120), Span("k", 98, 101), Span("k", 170, 180)]
    return host, dev


@pytest.mark.parametrize("kind", ["solve", "train"])
def test_shares_and_outside_add_up_to_the_idle_share(kind):
    host, dev = _step(kind)
    ctx = _ctx(dev, host, 200, kind)
    by = idle_by_span(dev, host)
    assert "outside" in by
    total = sum(idle_pct(ctx, [n]) for n in by)
    assert total == pytest.approx(100.0 * (1.0 - ctx.busy_s / ctx.window_s), abs=1e-9)
    # the cell's readers take every span: with "outside" they make the whole
    cell = sum(_reader(n).read(ctx) for n in IDLE if n.endswith("." + kind))
    assert cell + idle_pct(ctx, ["outside"]) == pytest.approx(total, abs=1e-9)


def test_a_window_past_the_host_events_is_idle_no_span_takes():
    # the window, on the host's clock, runs 50 us past the last host event:
    # the shares add up to the idle time inside the host events' extent
    host, dev = _step()
    ctx = _ctx(dev, host, 250)
    by = idle_by_span(dev, host)
    total = sum(idle_pct(ctx, [n]) for n in by)
    idle_in_extent = 200e-6 - ctx.busy_s
    assert total == pytest.approx(100.0 * idle_in_extent / ctx.window_s, abs=1e-9)
    assert total < 100.0 * (1.0 - ctx.busy_s / ctx.window_s) - 19.9


def test_every_span_of_the_program_has_a_layer():
    from theseus_tpu_torch.tracing import SPANS

    names = [n for group in LAYERS.values() for n in group]
    assert sorted(names) == sorted(SPANS)


def test_no_program_span_reads_none():
    host = [Span("aten::add", 0, 10)]
    assert idle_by_span(DEV, host) is None
    for name in IDLE:
        kind = name.rsplit(".", 1)[1]
        assert _reader(name).read(_ctx(DEV, host, 100, kind)) is None


def test_the_readers_are_in_the_benchmark():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    # each layer in each cell; the backward only in the training cell
    assert sorted(IDLE) == sorted([f"idle_{k}_pct.solve" for k in LAYERS if k != "backward"]
                                  + [f"idle_{k}_pct.train" for k in LAYERS])
    for name in IDLE:
        m = entries[name]
        kind = name.rsplit(".", 1)[1]
        assert (m["unit"], m["better"], m["source"]) == ("%", "lower", "device_trace")
        assert m["workloads"] == [f"pgo_sphere2500.{kind}_b64"]
        assert m["moves"] == {"solve": "solves_per_s", "train": "train_steps_per_s"}[kind]
        # a layer keeps one name in both cells
        assert m["layer"] == entries[name.replace(kind, "solve") if "backward" not in name else name]["layer"]
        # a reader of the other kind of cell reads nothing
        other = "train" if kind == "solve" else "solve"
        assert _reader(name).read(_ctx(DEV, HOST, 100, other)) is None


@pytest.mark.parametrize("cell", ["pgo_sphere2500.solve_b64", "pgo_sphere2500.train_b64"])
def test_a_traced_run_reads_every_idle_metric(cell):
    # on the CPU no operation runs on a device: every moment of the host
    # events' extent is idle, and the program's spans take most of it
    r = run_tiny(cell, trace=1)
    kind = cell.split(".")[1].split("_")[0]
    mine = [n for n in IDLE if n.endswith("." + kind)]
    assert set(mine) <= set(r["metrics"])
    shares = sum(r["metrics"][n]["value"] for n in mine)
    assert 0.0 < shares <= r["metrics"][f"device_idle_pct.{kind}"]["value"] + 1e-9
