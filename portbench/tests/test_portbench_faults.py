"""Each fault a cell can have, planted under the timed path at a tiny size
on the CPU, makes `correct` come out false (a cell on one chip has no
exchange between chips to leave out; a batch of one has no half)."""

import pytest

from _tiny import run_tiny
from portbench import faults

CASES = [(c, f) for c in ("pgo_sphere2500.solve_b64", "pgo_sphere2500.train_b64")
         for f in ("unchanged", "half_batch", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    r = run_tiny(cell, 0, fault=faults.FAULTS[fault])
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", ["pgo_sphere2500.solve_b64", "pgo_sphere2500.train_b64"])
def test_sound_run_is_correct(cell):
    assert run_tiny(cell, 0)["correct"] is True
