"""The generators repeat by seed and keep the published counts."""

import json

import pytest
import torch

from _tiny import ROOT, SEED, SPEC, TINY, tiny_problem
from portbench.configs import pgo_se3_sphere2500 as pgo_cfg
from portbench.run import Cell


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_pgo_grid_keeps_sphere2500_counts():
    cfg = _cfg("pgo_se3_sphere2500")
    lay = cfg["layout"]
    edges, loop = pgo_cfg.grid_edges(lay["rows"], lay["cols"])
    assert lay["rows"] * lay["cols"] == cfg["n_poses"] == 2500
    assert len(edges) == cfg["n_edges"] == 4900
    assert int((~loop).sum()) == 2499 and int(loop.sum()) == 2401
    assert len(set(edges)) == len(edges) and all(i < j for i, j in edges)


def test_a_layout_that_misstates_its_counts_is_refused():
    cfg, traffic = TINY["pgo_sphere2500.solve_b64"]
    cell = Cell(SPEC, "pgo_sphere2500.solve_b64", dict(cfg, n_edges=cfg["n_edges"] + 1), traffic)
    with pytest.raises(ValueError, match="edges"):
        cell.problem(SEED, "cpu")


@pytest.mark.parametrize("cell", list(TINY))
def test_draws_repeat_by_seed(cell):
    p, q, r = tiny_problem(cell, 7), tiny_problem(cell, 7), tiny_problem(cell, 8)
    flat = lambda prob: torch.cat([torch.as_tensor(v).reshape(-1) for i in range(2)  # noqa: E731
                                   for v in prob.inputs(i).values()])
    assert torch.equal(flat(p), flat(q))
    assert not torch.equal(flat(p), flat(r))
