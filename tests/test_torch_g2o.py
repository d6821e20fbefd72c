"""The 3-D g2o reader of theseus_tpu_torch against the JAX package's, on the CPU.

The cases of tests/optim/test_g2o_format.py for SE3 graphs, on the port:
the fixture tests/fixtures/mini_3d.g2o parsed to the JAX reader's poses,
measurements and sqrt-information weights (1e-12) and to the hand-computed
values, the parsed graph solved back to zero error through
`build_pgo_objective` (its measurements are exactly consistent; < 1e-10
in float64, on the level plan and with the whole graph amalgamated into the
dense tail), and a malformed line rejected.
"""

import pathlib

import numpy as np
import pytest
import torch

from theseus_tpu.utils.examples.pose_graph import read_3d_g2o as jread_3d_g2o
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, read_3d_g2o

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "mini_3d.g2o"


def _rz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def test_read_3d_g2o_matches_jax_reader():
    n, poses, edges, meas, w = read_3d_g2o(FIXTURE, device="cpu")
    jn, jposes, jedges, jmeas, jw = jread_3d_g2o(str(FIXTURE))
    assert (n, edges) == (jn, jedges) == (3, [(0, 1), (1, 2)])
    for got, want in ((poses, jposes), (meas, jmeas), (w, jw)):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float64 and got.device.type == "cpu"
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_read_3d_g2o_contract():
    _, poses, _, meas, w = read_3d_g2o(FIXTURE, dtype=torch.float32, device="cpu")
    assert poses.dtype == meas.dtype == w.dtype == torch.float32
    poses, meas, w = poses[:, 0].double().numpy(), meas[:, 0].double().numpy(), w.double().numpy()
    # vertices: identity, Rz(pi/2 + 0.05) at (1, 2, 3), Rx(pi) at (-0.9, 0.45, 2.08)
    np.testing.assert_allclose(poses[0], np.eye(3, 4), atol=1e-6)
    np.testing.assert_allclose(poses[1][:, :3], _rz(np.pi / 2 + 0.05), atol=1e-6)
    np.testing.assert_allclose(poses[1][:, 3], [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(poses[2][:, :3], np.diag([1.0, -1.0, -1.0]), atol=1e-6)
    np.testing.assert_allclose(poses[2][:, 3], [-0.9, 0.45, 2.08], atol=1e-6)
    # edges: the exact relative poses
    np.testing.assert_allclose(meas[0][:, :3], _rz(np.pi / 2), atol=1e-6)
    np.testing.assert_allclose(meas[1][:, :3], [[0, -1, 0], [-1, 0, 0], [0, 0, -1.0]], atol=1e-6)
    np.testing.assert_allclose(meas[1][:, 3], [-1.5, 2, -1], atol=1e-6)
    # sqrt-information W = L^T, upper triangular, W^T W = info
    info0 = np.diag([1.0, 2, 3, 4, 5, 6])
    info0[0, 1] = info0[1, 0] = 0.5
    np.testing.assert_allclose(w[0].T @ w[0], info0, atol=1e-5)
    np.testing.assert_allclose(w[1].T @ w[1], np.eye(6), atol=1e-6)
    np.testing.assert_allclose(w[0], np.triu(w[0]), atol=0)


@pytest.mark.parametrize("tail", [False, True], ids=["levels", "dense_tail"])
def test_3d_g2o_solvable(tail, monkeypatch):
    """LM from the perturbed vertices back to zero error; with the tail's
    minimum size lowered, the whole graph is one dense supernode."""
    if tail:
        monkeypatch.setattr(config, "SPARSE_TAIL_MIN_K", 1)
    n, poses, edges, meas, _ = read_3d_g2o(FIXTURE, device="cpu")
    obj, _ = build_pgo_objective(n, edges, meas, poses[0], dtype=torch.float64, device="cpu")
    opt = tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True, linearization="sparse")
    assert (opt.normal_builder.sched.tail_k > 0) == tail
    _, info = tt.TheseusLayer(opt).forward(pose_values(poses))
    assert float(info.err_history[0].mean()) > 1e-3
    assert float(info.last_err.mean()) < 1e-10


def test_3d_g2o_rejects_missing_tokens(tmp_path):
    bad = tmp_path / "bad.g2o"
    bad.write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0\n")  # 7 fields, needs 8
    with pytest.raises((ValueError, IndexError)):
        read_3d_g2o(bad, device="cpu")
