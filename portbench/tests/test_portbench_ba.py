"""The BAL Dubrovnik-356 cell (configs/ba_bal_dubrovnik356.py) on the CPU:
the generator keeps BAL's counts, the readers of its three per-layer
metrics read hand-made traces, and a run with the intrinsics frozen is not
correct where a sound one is, at a tiny size."""

import json
from types import SimpleNamespace

import pytest
import torch

from _tiny import ROOT, SEED, SPEC
from portbench import run
from portbench.configs import ba_bal_dubrovnik356 as ba_cfg
from portbench.trace_reduce import Span, busy_seconds
from theseus_tpu_torch.utils.examples.bundle_adjustment import bal_tracks, track_lengths

CELL = "ba_dubrovnik356.solve_b1"
TINY = {"n_cameras": 8, "n_points": 60, "n_observations": 332}


def _cfg():
    return json.loads((ROOT / "portbench" / "configs" / "ba_bal_dubrovnik356.json").read_text())


def _reader(name):
    return run.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))


def _run(trace=0, fault=None, seed=SEED):
    return run.run_cell(SPEC, CELL, seed, 0.2, trace, device="cpu", cfg_override=TINY, fault=fault, t0=0.0)


def test_track_lengths_keep_the_bal_counts():
    cfg = _cfg()
    assert (cfg["n_cameras"], cfg["n_points"], cfg["n_observations"], cfg["camera_params"]) == (356, 226730, 1255268, 9)
    gen = torch.Generator().manual_seed(SEED)
    k = track_lengths(gen, 356, 226730, 1255268, cfg["tracks"]["extra_mean"], "cpu")
    assert len(k) == 226730 and int(k.sum()) == 1255268
    assert int(k.min()) >= 2 and int(k.max()) <= 356


def test_tracks_are_distinct_cameras_camera_major():
    gen = torch.Generator().manual_seed(SEED)
    k = track_lengths(gen, 40, 500, 2768, 3.536, "cpu")
    cam, pt = bal_tracks(gen, 40, k, "cpu")
    assert len(cam) == 2768 and torch.equal(torch.bincount(pt, minlength=500), k)
    assert len(set(zip(cam.tolist(), pt.tolist()))) == 2768
    assert bool((cam[1:] >= cam[:-1]).all())


def test_problem_repeats_by_seed_and_sees_every_point_ahead():
    c = run.Cell(SPEC, CELL, dict(TINY, dtype="float64"))
    p, q, r = c.problem(7, "cpu"), c.problem(7, "cpu"), c.problem(8, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.pool[1], q.pool[1]))
    assert not torch.equal(p.pool[1][1], r.pool[1][1])
    # the tracks are the configuration's, whatever the run's seed
    assert torch.equal(p.obs_cam, r.obs_cam) and torch.equal(p.obs_pt, r.obs_pt)
    pose, pt = p.pool[0][0][p.obs_cam], p.pool[0][1][p.obs_pt]
    assert bool(((pose[..., :3] @ pt[..., None])[..., 2, 0] + pose[..., 2, 3] < 0).all())
    shapes = p.shapes()
    k = torch.bincount(p.obs_pt, minlength=60)
    assert shapes["pairs_useful"] == int((k * k).sum()) and shapes["dc"] == 9


def test_a_configuration_that_misstates_its_counts_is_refused():
    c = run.Cell(SPEC, CELL, dict(TINY, n_observations=8 * 60 + 1))
    with pytest.raises(ValueError, match="observations"):
        c.problem(SEED, "cpu")


def test_sound_run_is_correct_and_frozen_intrinsics_are_not():
    r = _run()
    assert r["correct"] is True and set(r["checks"]) == {"cost_gap", "intrinsics_gap"}
    bad = _run(fault=ba_cfg.freeze_intrinsics)
    assert bad["correct"] is False
    assert bad["checks"]["intrinsics_gap"]["value"] == pytest.approx(1.0)


def test_traced_run_reports_the_idle_share():
    r = _run(trace=1)
    assert r["correct"] is True
    # the CPU runs no device operation: no roofline, the idle split only
    assert set(r["metrics"]) == {"idle_schur_pct.solve"}
    assert 0.0 < r["metrics"]["idle_schur_pct.solve"]["value"] <= 100.0


def _ctx(dev, host=(), shapes=None, window_us=1000.0, kind="solve"):
    shapes = shapes or {"batch": 1, "n_obs": 1000, "n_cams": 10, "n_pts": 200, "dc": 9, "dp": 3,
                        "iterations": 2, "pairs_useful": 6000, "pairs_padded": 20000}
    return SimpleNamespace(kind=kind, dev=list(dev), host=list(host), busy_s=busy_seconds(dev),
                           window_s=window_us * 1e-6, shapes=shapes, itemsize=4)


def test_reprojection_roofline_reads_the_intrinsics_kernel():
    from portbench.counts import peaks, reprojection

    dev = [Span("void reprojection_intr_kernel<float>(...)", 0, 2), Span("reprojection_kernel<float>", 3, 4),
           Span("void reprojection_intr_kernel<float>(...)", 5, 9)]
    ctx = _ctx(dev)
    least = peaks.least_seconds(*reprojection.reprojection_intr(ctx.shapes, 4))
    assert reprojection.reprojection_intr(ctx.shapes, 4)[1] == 1000 * 184
    assert _reader("reprojection_roofline_pct").read(ctx) == pytest.approx(100.0 * 2 * least / 6e-6)
    assert _reader("reprojection_roofline_pct").read(_ctx(dev[1:2])) is None


def test_schur_stages_run_from_an_assembly_to_the_cholesky_of_s():
    reader = _reader("schur_roofline_pct")
    names = ["reprojection_intr_kernel", "assemble_kernel", "mul", "index", "bmm", "indexFuncLargeIndex",
             "getrf_wo_pivot_kernel", "trsm", "reprojection_intr_kernel", "assemble_kernel", "mul", "potrf_x"]
    dev = [Span(n, 10.0 * k, 10.0 * k + 1 + k) for k, n in enumerate(names)]
    seconds, stages = reader.schur_stages(dev)
    # two stages: mul, index, bmm, indexFunc (3..6 us) and mul (11 us)
    assert stages == 2 and seconds == pytest.approx((3 + 4 + 5 + 6 + 11) * 1e-6)
    from portbench.counts import peaks, schur

    ctx = _ctx(dev)
    want = 100.0 * 2 * peaks.least_seconds(*schur.reduction(ctx.shapes, 4)) / seconds
    assert reader.read(ctx) == pytest.approx(want)
    # a program whose builder has no pair counts reads nothing
    assert reader.read(_ctx(dev, shapes={"batch": 1})) is None


def test_idle_schur_takes_the_four_schur_spans():
    host = [Span("tt.forward", 0, 100), Span("tt.solve", 10, 90), Span("tt.schur.eliminate", 10, 20),
            Span("tt.schur.reduce", 20, 50), Span("tt.schur.factor", 50, 60), Span("tt.schur.backsub", 60, 80)]
    dev = [Span("k", 12, 18), Span("k", 25, 45), Span("k", 62, 70)]
    # idle in the Schur spans: 10..12, 18..20 | 20..25, 45..50 | 50..60 | 60..62, 70..80
    got = _reader("idle_schur_pct.solve").read(_ctx(dev, host, window_us=100.0))
    assert got == pytest.approx(100.0 * (4 + 10 + 10 + 12) / 100.0)
    assert _reader("idle_schur_pct.solve").read(_ctx(dev, host, window_us=100.0, kind="train")) is None
