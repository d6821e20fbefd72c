"""The example scripts of theseus_tpu_torch (examples_torch/) run on the CPU, and their config shim (examples_torch/_config.py).

- every script of examples/ but _config.py has its examples_torch
  counterpart of the same name, and no more;
- each script's `main([... "--device", "cpu"])` runs in this process at
  the small arguments of tests/test_examples_smoke.py, under a guard that
  fails any import of jax or of the JAX package, and its own asserts hold
  (they are the JAX script's). motion_planning_learned runs at its
  committed config instead (10 steps at batch 4, about a second): its
  assert compares the planner error of fresh random problems, and over the
  smoke test's 2 steps that is a draw of two problems (the port's seed-0
  draws give the second the larger error);
- every committed examples/configs/**/*.yaml reads through the shim exactly
  as PyYAML reads it, and its keys name options of the torch script;
- the shim's override rules (the JAX package's tests/test_example_configs.py
  cases) and its refusal of YAML it does not read.
"""

import argparse
import importlib
import pathlib
import re
import sys

import pytest
import yaml

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORT = ROOT / "examples_torch"
sys.path.insert(0, str(ROOT))

from examples_torch import _config  # noqa: E402

SMALL = {
    "simple_example": [],
    "lie_api": [],
    "backward_modes": [],
    "state_estimation_2d": ["--epochs", "3"],
    "se2_inverse": ["--iters", "50"],
    "se2_planning": [],
    "pose_graph_cube": ["--n-per-edge", "2"],
    "gbp_pose_graph": ["--n-poses", "6", "--msg-iters", "25", "--max-iterations", "8"],
    "motion_planning_learned": ["--config", str(EXAMPLES / "configs" / "motion_planning_learned.yaml")],
    "pose_graph_synthetic": ["--n-poses", "16", "--batch", "2", "--epochs", "2"],
    "pose_graph_benchmark": ["--n-poses", "32", "--iters", "3"],
    "bundle_adjustment": ["--cameras", "4", "--points", "16"],
    "inverse_kinematics": [],
    "motion_planning_2d": [],
    "tactile_pose_estimation": ["--time-steps", "4", "--outer-steps", "1"],
    "homography_estimation": [],
    "homography_learned": ["--steps", "2", "--batch", "2", "--patch-stride", "12", "--channels", "2"],
}


def test_every_jax_example_has_a_port():
    jax_scripts = {p.stem for p in EXAMPLES.glob("*.py") if p.name != "_config.py"}
    port_scripts = {p.stem for p in PORT.glob("*.py") if not p.name.startswith("_")}
    assert port_scripts == jax_scripts
    assert set(SMALL) == jax_scripts


class _NoJax:
    """A meta-path finder that fails any import of jax or theseus_tpu."""

    @staticmethod
    def find_spec(name, *args):
        if name.split(".")[0] in ("jax", "jaxlib", "theseus_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


@pytest.mark.parametrize("script", list(SMALL))
def test_example_runs_on_cpu(script, monkeypatch):
    for name in [m for m in sys.modules if m == f"examples_torch.{script}"]:
        monkeypatch.delitem(sys.modules, name)
    jax_mods = {m: sys.modules[m] for m in list(sys.modules) if m.split(".")[0] in ("jax", "jaxlib", "theseus_tpu")}
    # hide the JAX modules this process already holds, and refuse new imports
    for m in jax_mods:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setattr(sys, "meta_path", [_NoJax] + sys.meta_path)
    mod = importlib.import_module(f"examples_torch.{script}")
    mod.main(SMALL[script] + ["--device", "cpu"])


def _options(script: str):
    src = (PORT / f"{script}.py").read_text()
    return set(re.findall(r"add_argument\(\s*[\"']--([\w-]+)[\"']", src))


@pytest.mark.parametrize("cfg", sorted(EXAMPLES.glob("configs/**/*.yaml")), ids=lambda p: p.stem)
def test_committed_configs_bind(cfg):
    """The shim reads every committed config as PyYAML does, and each key
    names an option of the torch script of the config's name."""
    keys = _config.load_flat_yaml(cfg)
    assert keys == (yaml.safe_load(cfg.read_text()) or {})
    opts = _options(cfg.stem)
    assert "device" in opts
    for k in keys:
        assert k.replace("_", "-") in opts, f"{cfg.name}: {k!r} is no option of examples_torch/{cfg.stem}.py"


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--n-poses", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--joints", type=float, nargs=2, default=[0.0, 0.0])
    p.add_argument("--f32", action="store_true")
    return p


@pytest.mark.parametrize("text,argv,want", [
    ("n-poses: 128\n", [], {"n_poses": 128, "lr": 0.1}),  # the file overrides the defaults
    ("n-poses: 128\nlr: 0.5\n", ["--n-poses", "32"], {"n_poses": 32, "lr": 0.5}),  # flags win
    ("n_poses: 7\n", [], {"n_poses": 7}),  # underscores
    ("# a comment\njoints: [0.4, -0.6]  # trailing\nf32: true\n", [], {"joints": [0.4, -0.6], "f32": True}),
    ("lr: 1e-3\n", [], {"lr": 1e-3}),
])
def test_config_overrides(tmp_path, text, argv, want):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(text)
    args = _config.parse_with_config(_parser(), ["--config", str(cfg)] + argv)
    for k, v in want.items():
        assert getattr(args, k) == v


def test_unknown_key_exits(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("not-an-option: 1\n")
    with pytest.raises(SystemExit):
        _config.parse_with_config(_parser(), ["--config", str(cfg)])


@pytest.mark.parametrize("text", ["nested:\n  a: 1\n", "items:\n  - 1\n", "k: {a: 1}\n", "k: [[1], 2]\n",
                                  "just text\n", "k: &anchor 1\n"])
def test_unsupported_yaml_raises(tmp_path, text):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(text)
    with pytest.raises(ValueError):
        _config.load_flat_yaml(cfg)
