"""The shape of a run's result, and the runs that must print none."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT, SPEC, TINY, run_tiny

CELLS = list(TINY)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    r = run_tiny(cell, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    names = set(r["metrics"])
    if trace:
        listed = {m["name"] for m in SPEC["per_layer"] if cell in m.get("workloads", [cell])}
        assert names <= listed
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        listed = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
        assert names == listed and "setup_s" in names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(r)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_factor_stages_run_from_an_assembly_to_a_forward_substitution():
    from portbench import run
    from portbench.trace_reduce import Span

    reader = run.load_module(ROOT / "portbench" / "metrics" / "factor_roofline_pct.py", "factor_reader")
    names = ["between_kernel", "assemble_kernel", "mul", "index", "level_factor_kernel", "gemm", "potrf_x",
             "fwd_subst_kernel", "bwd_subst_kernel", "assemble_kernel", "mul", "fwd_subst_kernel"]
    dev = [Span(n, 10.0 * k, 10.0 * k + 1 + k) for k, n in enumerate(names)]
    seconds, stages = reader.factor_stages(dev)
    # one stage: mul, index, level_factor, gemm, potrf (durations 3..7 us);
    # the second run holds no factor kernel
    assert stages == 1 and seconds == pytest.approx((3 + 4 + 5 + 6 + 7) * 1e-6)
