"""The control (the plain reference in the program's place, in the
precision limits/<cell>.json names) reads past each cell's limit, at the
cell's own size, on the card. Run there with

    python -m pytest -q -m cuda portbench/tests/test_portbench_control.py
"""

import json

import pytest
import torch

from _tiny import ROOT, SPEC

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's own size")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_a_limit(cuda_device, cell):
    from portbench import control
    from portbench.run import Cell

    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())["limits"]
    got = control.reading(Cell(SPEC, cell), 2**31 + 101, "control", device=cuda_device)
    assert any(not (v <= limits[k]) for k, v in got.items()), (got, limits)
