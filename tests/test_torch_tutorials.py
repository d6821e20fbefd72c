"""Run every tutorial of docs/tutorials_torch on the CPU, each in a subprocess.

Each tutorial is the port of its docs/tutorials twin and asserts the same
outcome (a solved curve fit, learned observations, verified jacobians, a
collision-free plan, a learned collision weight, GBP's marginals); it
prints "OK" at its end. `--device cpu` runs it on the plain PyTorch
twins; without it a tutorial runs on the card.
"""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TUTORIALS = sorted(p.name for p in (ROOT / "docs" / "tutorials_torch").glob("0*.py"))


def test_every_jax_tutorial_has_a_port():
    assert TUTORIALS == sorted(p.name for p in (ROOT / "docs" / "tutorials").glob("0*.py"))


@pytest.mark.parametrize("script", TUTORIALS)
def test_tutorial_runs_on_cpu(script):
    # the tutorial runs under a guard that fails any import of jax or of the JAX package
    guard = ("import sys, runpy; sys.argv = sys.argv[1:]; "
             "sys.meta_path.insert(0, type('G', (), {'find_spec': staticmethod(lambda n, *a: "
             "(_ for _ in ()).throw(ImportError(n)) if n.split('.')[0] in ('jax', 'theseus_tpu') else None)})); "
             "runpy.run_path(sys.argv[0], run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", guard, str(ROOT / "docs" / "tutorials_torch" / script),
                          "--device", "cpu"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, f"{script} failed:\nstdout:\n{out.stdout[-2000:]}\nstderr:\n{out.stderr[-2000:]}"
    assert "OK" in out.stdout.splitlines()[-1]
