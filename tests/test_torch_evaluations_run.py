"""The evaluation scripts of theseus_tpu_torch (evaluations_torch/) run on the CPU.

- one port script for each JAX evaluation script of evaluations/ that is
  not ported elsewhere (serving_throughput.py is scripts/torch_serving.py);
- each script's main() with --device cpu at a tiny size, in this process,
  under a guard that fails any import of jax or of the JAX package,
  writing its results file into a temporary directory. The learning run
  of the tactile sweep is cut to 1 step and the vectorization window to
  (1, 1) iterations: the CPU times are not what this checks.

The scripts' computations against the JAX scripts' functions are
tests/test_torch_evaluations.py.
"""

import importlib
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EVALS = ROOT / "evaluations"
PORT = ROOT / "evaluations_torch"
sys.path.insert(0, str(ROOT))

# JAX evaluation scripts whose port lives elsewhere
PORTED_ELSEWHERE = {"serving_throughput": "scripts/torch_serving.py"}

# each script at a tiny size: (argv, keyword arguments of main)
SMALL = {
    "vectorization_ablation": (["--sizes", "6", "--batch", "2"], {}),
    "backward_modes_sweep": (["--n-poses", "5", "--batch", "2", "--inner-iters", "3"], {}),
    "backward_modes_tactile": (["--time-steps", "3", "--inner-iters", "2"], {}),
    "autodiff_ablation": ([], {}),
    "time_local_cost_backward": (["--batches", "2", "--groups", "SO3"], {}),
    "gbp_eval": ([], {"sizes": (8,)}),
    "gbp_hw_bench": ([], {"shapes": ((6, 2),)}),
}

@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the scripts run thousands of tiny ops (GBP's
    6 x 6 solves), and with every xdist worker's pool spinning on the same
    cores each op waits for the others (gbp_hw_bench's smoke run took
    minutes instead of seconds)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# module constants cut for the smoke run
CUTS = {"vectorization_ablation": {"WINDOW": (1, 1)}, "backward_modes_tactile": {"LEARN_STEPS": 1}}


def test_one_port_per_jax_evaluation():
    jax_scripts = {p.stem for p in EVALS.glob("*.py")}
    port_scripts = {p.stem for p in PORT.glob("*.py") if not p.name.startswith("_")}
    assert port_scripts == jax_scripts - set(PORTED_ELSEWHERE)
    assert set(SMALL) == port_scripts
    assert all((ROOT / f).exists() for f in PORTED_ELSEWHERE.values())


class _NoJax:
    """A meta-path finder that fails any import of jax or theseus_tpu."""

    @staticmethod
    def find_spec(name, *args):
        if name.split(".")[0] in ("jax", "jaxlib", "theseus_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


@pytest.mark.parametrize("script", list(SMALL))
def test_evaluation_runs_on_cpu(script, monkeypatch, tmp_path):
    for name in [m for m in sys.modules if m.startswith("evaluations_torch")]:
        monkeypatch.delitem(sys.modules, name)
    for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "theseus_tpu")]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setattr(sys, "meta_path", [_NoJax] + sys.meta_path)
    mod = importlib.import_module(f"evaluations_torch.{script}")
    out = tmp_path / mod.OUT.name
    monkeypatch.setattr(mod, "OUT", out)
    for name, cut in CUTS.get(script, {}).items():
        monkeypatch.setattr(mod, name, cut)
    argv, kwargs = SMALL[script]
    result = mod.main(argv + ["--device", "cpu"], **kwargs)
    assert result
    text = out.read_text() if out.exists() else next(tmp_path.glob("*.md")).read_text()
    assert "Card: CPU" in text and "| " in text
