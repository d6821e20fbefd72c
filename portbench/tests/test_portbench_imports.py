"""No run and no reference loads jax or the JAX package; names are compared
whole up to the first dot, so the port passes and the JAX package fails."""

import subprocess
import sys

from _tiny import ROOT
from portbench.run import forbidden_modules


def test_top_level_names_compared_whole():
    assert forbidden_modules(["theseus_tpu_torch", "theseus_tpu_torch.core", "numpy"]) == []
    assert forbidden_modules(["theseus_tpu.core"]) == ["theseus_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping"]) == []


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    names = _loaded_after("import portbench.reference.pgo, portbench.reference.lm, portbench.reference.precision")
    assert not names & {"theseus_tpu_torch", "theseus_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_forbidden_module():
    names = _loaded_after(
        "import sys; sys.path.insert(0, 'portbench/tests'); from _tiny import run_tiny\n"
        "r = run_tiny('pgo_sphere2500.solve_b64', 1); assert r['correct']")
    assert "theseus_tpu_torch" in names
    assert not names & {"theseus_tpu", "jax", "jaxlib", "flax"}
