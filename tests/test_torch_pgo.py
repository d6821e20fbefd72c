"""The whole PGO slice of theseus_tpu_torch against the JAX package, on the CPU.

The JAX package's 16-pose x batch-4 problem, in float64, carried into the
port through utils/convert.py and solved by both `TheseusLayer.forward`
(Levenberg-Marquardt, adaptive damping, sparse linearization). Final
errors agree to 1e-9 relative and poses to 1e-9 absolute: the same
algorithm in float64, differing only in rounding order (and, below its
level-count cap, the JAX package factoring column by column where the port
factors level by level).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils.examples.pose_graph import (
    build_pgo_objective as jbuild,
    pose_values as jpose_values,
    synthetic_pose_graph as jsynthetic,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch.utils.convert import problem_from_arrays

REPO = Path(__file__).resolve().parents[1]
N, B, ITERS = 16, 4, 20


def _arrays(n=N, b=B, dtype=jnp.float64):
    gt, edges, meas, init = jsynthetic(n_poses=n, batch=b, seed=0, dtype=dtype)
    return dict(gt=np.array(gt), edges=np.array(edges), measurements=np.array(meas),
                init=np.array(init), prior_weight=10.0), (gt, edges, meas, init)


def _port_layer(arrays, dtype=torch.float64, cls=tt.LevenbergMarquardt, **kw):
    obj, inputs = problem_from_arrays(arrays, dtype=dtype)
    kw.setdefault("adaptive_damping", cls is tt.LevenbergMarquardt)
    return tt.TheseusLayer(cls(obj, max_iterations=ITERS, **kw)), inputs


def test_lm_solve_matches_jax_layer():
    arrays, (gt, edges, meas, init) = _arrays()
    jobj, _ = jbuild(N, edges, meas, gt[0], dtype=jnp.float64)
    jlayer = jt.TheseusLayer(jt.LevenbergMarquardt(
        jobj, max_iterations=ITERS, adaptive_damping=True, linearization="sparse"))
    jout, jinfo = jlayer.forward(jpose_values(init))

    layer, inputs = _port_layer(arrays)
    out, info = layer.forward(inputs)
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=1e-9)
    np.testing.assert_array_equal(info.converged_iter.numpy(), np.asarray(jinfo.converged_iter))
    np.testing.assert_array_equal(info.status.numpy(), np.asarray(jinfo.status))
    for i in range(N):
        np.testing.assert_allclose(out[f"pose_{i}"].numpy(), np.asarray(jout[f"pose_{i}"]), atol=1e-9)


def test_gauss_newton_reaches_lm_plateau():
    arrays, _ = _arrays()
    lm, inputs = _port_layer(arrays)
    gn, _ = _port_layer(arrays, cls=tt.GaussNewton)
    _, lm_info = lm.forward(inputs)
    _, gn_info = gn.forward(inputs)
    torch.testing.assert_close(gn_info.last_err, lm_info.last_err, rtol=1e-6, atol=0)


def test_diagonal_weight_equals_scale_weight():
    """DiagonalCostWeight(s * ones) and ScaleCostWeight(s) on every edge are
    the same objective: equal solves (1e-12 relative, float64)."""
    from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values

    arrays, _ = _arrays(n=8, b=2)
    errs = []
    for weight in (tt.ScaleCostWeight(2.0), tt.DiagonalCostWeight(np.full(6, 2.0))):
        obj, _ = build_pgo_objective(8, [tuple(e) for e in arrays["edges"]], arrays["measurements"],
                                     arrays["gt"][0], dtype=torch.float64, edge_weight=weight)
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True))
        errs.append(layer.forward(pose_values(torch.as_tensor(arrays["init"])))[1].last_err)
    torch.testing.assert_close(errs[1], errs[0], rtol=1e-12, atol=0)


def test_run_while_stops_at_the_same_plateau():
    arrays, _ = _arrays()
    layer, inputs = _port_layer(arrays)
    opt, co = layer.optimizer, layer.objective.compile()
    values = layer.objective.default_values(inputs)
    state, aux = co.pack(values, B), co.build_aux(values, B)
    with torch.no_grad():
        scan = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, ITERS, opt.opts)
        early = opt.run_while(opt.init_carry(state, aux, opt.opts), aux, ITERS, opt.opts)
    assert early["it"] < ITERS  # stopped once every element converged
    torch.testing.assert_close(early["err"], scan["err"], rtol=1e-12, atol=0)


def test_batch_ignore_mask_freezes_elements():
    arrays, _ = _arrays()
    layer, inputs = _port_layer(arrays)
    mask = torch.tensor([False, True, False, True])
    out, info = layer.forward(inputs, optimizer_kwargs={"batch_ignore_mask": mask})
    for i in range(N):
        assert torch.equal(out[f"pose_{i}"][mask], inputs[f"pose_{i}"][mask])
    assert (info.status[mask] == 0).all() and (info.status[~mask] == 1).all()


def test_float32_solve_close_to_float64_plateau():
    """The bench's working precision: the float32 plateau sits within 1e-4
    relative of the float64 one on this problem (float32 LM stalls once
    steps fall below its resolution)."""
    arrays, _ = _arrays()
    l64, in64 = _port_layer(arrays)
    l32, in32 = _port_layer(arrays, dtype=torch.float32)
    _, i64 = l64.forward(in64)
    _, i32 = l32.forward(in32)
    np.testing.assert_allclose(i32.last_err.double().numpy(), i64.last_err.numpy(), rtol=1e-4)


@pytest.mark.parametrize("case", ["requires_grad", "aux_requires_grad", "dense", "schur", "implicit_mode"])
def test_unported_paths_raise(case):
    arrays, _ = _arrays(n=8, b=2)
    if case in ("dense", "schur"):
        obj, _ = problem_from_arrays(arrays)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tt.LevenbergMarquardt(obj, linearization=case)
        return
    layer, inputs = _port_layer(arrays)
    kwargs = {"backward_mode": "implicit"} if case == "implicit_mode" else {}
    if case == "requires_grad":
        inputs["pose_3"] = inputs["pose_3"].clone().requires_grad_(True)
    elif case == "aux_requires_grad":
        prior = layer.objective.cost_functions["prior"]
        prior.aux_vars[0].tensor = torch.as_tensor(prior.aux_vars[0].tensor).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer.forward(inputs, optimizer_kwargs=kwargs)


def test_precision_is_pinned_to_full_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_import_leaves_jax_out():
    code = "import sys, theseus_tpu_torch, theseus_tpu_torch.utils.convert; print('jax' in sys.modules)"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert res.stdout.strip() == "False"


@pytest.mark.parametrize("path", ["chip_smoke.py", "theseus_tpu_torch"])
def test_port_sources_import_no_jax(path):
    files = [REPO / path] if path.endswith(".py") else sorted((REPO / path).rglob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "theseus_tpu"), f"{f}: imports {name}"
