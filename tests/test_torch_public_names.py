"""Every public name that a subpackage `__init__` of theseus_tpu binds imports from the port's counterpart.

A static read of the JAX package's `__init__.py` files (ast, no import of
jax): the names bound by relative imports (`from .x import a`, `from .
import x`), by top-level `def`, `class` and assignments, and listed in
`__all__`, less names that start with an underscore. Absolute imports
(os, numpy, jax) are the module's tools, not its API. Skipped: what
ROADMAP.md lists as deliberately not ported (`utils/hoist.py`,
`utils/host.py` and the XLA/Mosaic settings behind `set_use_pallas` and
`set_pallas_whole`).
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "theseus_tpu"

# names ROADMAP.md lists as deliberately not ported, by JAX module
NOT_PORTED = {
    "theseus_tpu.utils": {"hoist_jit", "local_cpu", "on_host", "to_device"},
}


def _bound_names(init: pathlib.Path):
    tree = ast.parse(init.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__" and isinstance(node.value, (ast.List, ast.Tuple)):
                        names.update(e.value for e in node.value.elts if isinstance(e, ast.Constant))
    return sorted(n for n in names if not n.startswith("_") and n != "*")


def _subpackages():
    inits = sorted(JAX_PKG.glob("**/__init__.py"))
    return [".".join(p.relative_to(ROOT).parent.parts) for p in inits]


def test_the_jax_package_has_subpackages():
    subs = _subpackages()
    assert "theseus_tpu.ops" in subs and "theseus_tpu.optim" in subs and "theseus_tpu" in subs


@pytest.mark.parametrize("jax_mod", _subpackages())
def test_public_names_import_from_the_port(jax_mod):
    init = ROOT.joinpath(*jax_mod.split(".")) / "__init__.py"
    port = importlib.import_module(jax_mod.replace("theseus_tpu", "theseus_tpu_torch", 1))
    skip = NOT_PORTED.get(jax_mod, set())
    missing = [n for n in _bound_names(init) if n not in skip and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_f1_reexports():
    from theseus_tpu_torch.ops import (  # noqa: F401
        SMALL_DIM_MAX,
        chol_small,
        rt_solve_lower,
        solve_lower_mat,
        solve_lower_vec,
        solve_upper_vec,
    )
    from theseus_tpu_torch.optim import apply_damping  # noqa: F401
    from theseus_tpu_torch.ops import batched_linalg
    from theseus_tpu_torch.optim import linear

    assert chol_small is batched_linalg.chol_small and apply_damping is linear.apply_damping
