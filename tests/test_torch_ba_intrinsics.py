"""Bundle adjustment with BAL's 9-parameter cameras (f, k1, k2 optimised),
on the CPU in float64, against the plain reference of the benchmark
(portbench/reference/ba.py) and forward-mode autodiff.

A problem of 8 cameras and 60 points under the track rule of
`synthetic_bal` (tracks of 2 + a geometric draw, 332 observations):
- the kernel's twin and the cost's closed-form jacobians equal
  torch.func.jacfwd (1e-10 relative to each output's scale: the
  intrinsics' and the pose's carry f, ~1e3);
- a Schur step, each camera one 9-dof block of S (pose and intrinsics),
  equals a dense solve of the whole damped system (1e-10), on both
  elimination paths;
- 10 LM iterations equal the reference's (1e-8 relative, cost and state);
- the 6-dof build without intrinsics is as before.
The cuda test holds the intrinsics kernel to its twin on the card; it
imports no JAX, so it runs there with --noconftest.
"""

import numpy as np
import pytest
import torch

import theseus_tpu_torch as tt
from portbench.reference import ba as rba
from portbench.reference import lie as rlie
from portbench.reference import lm as rlm
from theseus_tpu_torch import _cuda, config
from theseus_tpu_torch.core import SE3, Point3, Vector
from theseus_tpu_torch.embodied import Reprojection
from theseus_tpu_torch.ops.reprojection import reprojection_intr_linearize, reprojection_intr_linearize_plain
from theseus_tpu_torch.optim.schur import SchurNormalBuilder
from theseus_tpu_torch.utils.examples.bundle_adjustment import (
    ba_values,
    build_ba_objective,
    eliminate_landmarks,
    load_bal,
    save_bal,
    synthetic_ba,
    synthetic_bal,
)

C, P, O, B, ITERS = 8, 60, 332, 2, 10
SOLVER = dict(adaptive_damping=True, ellipsoidal=True, damping=1e-3)


def _problem(seed=3, batch=B, dtype=torch.float64):
    return synthetic_bal(C, P, O, batch=batch, seed=seed, dtype=dtype, device="cpu")


def _inputs(K=13, batch=3, seed=0, dtype=torch.float64, device="cpu"):
    """pose, point, intrinsics, feat (K, B, ...): points 5 to 15 units
    ahead of the camera (P_z < 0), f ~ 1e3, k1 and k2 nonzero."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    pose = rlie.exp(t(0.2 * rng.standard_normal((K, batch, 6))))
    p_cam = t(np.concatenate([rng.uniform(-3, 3, (K, batch, 2)), -rng.uniform(5, 15, (K, batch, 1))], -1))
    point = (pose[..., :3].transpose(-1, -2) @ (p_cam - pose[..., 3])[..., None])[..., 0]
    intr = t(np.stack([rng.uniform(800, 1200, (K, batch)), rng.uniform(-0.2, 0.2, (K, batch)),
                       rng.uniform(-0.05, 0.05, (K, batch))], -1))
    return pose, point, intr, t(300.0 * rng.standard_normal((K, batch, 2)))


def _jacfwd(pose, point, intr, feat):
    """The BAL residual's jacobians by torch.func.jacfwd, per (k, b): along
    the pose's tangent x (I + d^), the point and (f, k1, k2)."""
    def res(d, x, i, p, f):
        return rba.project(rlie.perturb(p, d), x, i) - f

    flat = [a.reshape((-1,) + a.shape[2:]) for a in (pose, point, intr, feat)]
    zero = torch.zeros(flat[0].shape[0], 6, dtype=pose.dtype)
    jac = [torch.func.vmap(torch.func.jacfwd(res, argnums=n))(zero, flat[1], flat[2], flat[0], flat[3])
           for n in range(3)]
    return [j.reshape(pose.shape[:2] + j.shape[1:]) for j in jac]


def _close(got, want, rtol):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=rtol * scale, rtol=0)


def test_twin_matches_jacfwd_of_the_bal_projection():
    ops = _inputs()
    jpose, jpt, jintr, err = reprojection_intr_linearize_plain(*ops)
    for got, want in zip((jpose, jpt, jintr), _jacfwd(*ops)):
        _close(got, want, 1e-10)
    _close(err, rba.project(*ops[:3]) - ops[3], 1e-12)
    # on a CPU tensor the entry point is the twin
    _cuda.reset_launches()
    for got, want in zip(reprojection_intr_linearize(*ops), (jpose, jpt, jintr, err)):
        assert torch.equal(got, want)
    assert _cuda.launches["reprojection_intr"] == 0


def test_cost_jacobians_match_jacfwd_through_the_retract():
    pose, point, intr, feat = _inputs(K=5, batch=2, seed=1)
    cost = Reprojection(SE3(name="c"), Point3(name="p"), None, feat, intrinsics=Vector(3, name="i"))
    assert [v.name for v in cost.optim_vars] == ["c", "p", "i"] and len(cost.aux_vars) == 1
    jacs, err = cost.jacobians_impl([pose, point, intr], [feat])
    groups = [v.group for v in cost.optim_vars]
    xs = [pose, point, intr]
    for n, g in enumerate(groups):
        def along(d, n=n, g=g):
            moved = list(xs)
            moved[n] = g.retract(xs[n], d)
            return cost.error_impl(moved, [feat])

        zero = torch.zeros(xs[n].shape[:2] + (g.dof,), dtype=torch.float64)
        want = torch.func.jacfwd(along)(zero)  # (K, B, 2, K, B, dof): the diagonal
        want = torch.diagonal(torch.diagonal(want, dim1=0, dim2=3), dim1=0, dim2=2).permute(2, 3, 0, 1)
        _close(jacs[n], want, 1e-10)
    _close(err, cost.error_impl(xs, [feat]), 1e-12)
    # the fused path is the twin on the CPU
    (fp, fx, fi), ferr = cost.fused_linearize(xs, [feat])
    for a, b in zip((fp, fx, fi, ferr), (*jacs, err)):
        assert torch.equal(a, b)


def _schur(prob, optimize_intrinsics=True):
    out = build_ba_objective(prob, dtype=torch.float64, device="cpu", optimize_intrinsics=optimize_intrinsics)
    obj, pts = out[0], out[2]
    co = obj.compile()
    vals = obj.default_values(ba_values(prob, optimize_intrinsics=optimize_intrinsics))
    b = co.resolve_batch_size(vals)
    bld = SchurNormalBuilder(co, eliminate_landmarks(pts))
    return co, bld, bld.build(co.pack(vals, b), co.build_aux(vals, b)), vals, b


@pytest.fixture
def budget():
    old = config.SCHUR_DENSE_BUDGET_BYTES
    yield config.set_schur_dense_budget
    config.set_schur_dense_budget(old)


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("intrinsics", [True, False])
def test_schur_step_equals_the_dense_solve(budget, path, intrinsics):
    if path == "chunked":
        budget(0)
    prob = _problem()
    co, bld, ns, vals, b = _schur(prob, intrinsics)
    dc = 9 if intrinsics else 6
    assert (bld.n_cams, bld.cam_d) == (C, dc)
    assert bld.use_dense_elimination(b, torch.float64) == (path == "dense")
    lam = 1e-3
    delta, bad = ns.solve(lam, ellipsoidal=True)
    assert not bool(bad.any())
    a, rhs = co.dense_A_b(co.pack(vals, b), co.build_aux(vals, b))
    h = a.transpose(-1, -2) @ a
    dg = torch.diagonal(h, dim1=-2, dim2=-1)
    h = h + torch.diag_embed(lam * dg + bld.damping_eps)
    want = torch.linalg.solve(h, bld.flatten(ns.atb_blocks))
    _close(delta, want, 1e-10)


def test_pair_counts_are_the_track_sums():
    prob = _problem()
    _, bld, _, _, _ = _schur(prob)
    k = np.bincount(prob.obs_pt, minlength=P)
    assert bld.pair_counts() == (int(np.sum(k * k)), P * int(k.max()) ** 2)
    # each point's couplings are its k cameras, not 2k variables
    assert len(bld.cp_pt) == O


def _layer(prob, linearization="schur"):
    obj, _, pts, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0],
                                        optimize_intrinsics=True)
    opt = tt.LevenbergMarquardt(obj, max_iterations=ITERS, linearization=linearization, adaptive_damping=True,
                                ellipsoidal_damping=True, eliminate=eliminate_landmarks(pts))
    return tt.TheseusLayer(opt)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_lm_matches_the_reference(budget, path):
    if path == "chunked":
        budget(0)
    prob = _problem()
    out, info = _layer(prob).forward(ba_values(prob, optimize_intrinsics=True))
    ref = rba.BAL(C, P, torch.as_tensor(prob.obs_cam), torch.as_tensor(prob.obs_pt), prob.obs_img,
                  prob.gt_poses[0], 1e4)
    x, f = rba.solve(ref, (prob.poses, prob.points, prob.intrinsics), ITERS, rlm.options(SOLVER))
    assert bool((f < 0.5 * ref.cost((prob.poses, prob.points, prob.intrinsics))).all())
    torch.testing.assert_close(info.last_err, f, rtol=1e-8, atol=0)
    for got, want in zip((out["cam"], out["pt"], out["intr"]), x):
        _close(got, want, 1e-8)


def test_tracks_seed_fixes_the_tracks():
    """tracks_seed fixes the visibility graph, as a BAL file does, while
    seed draws the scene; intrinsics variables come in families only."""
    p, q = (synthetic_bal(C, P, O, seed=s, tracks_seed=11, dtype=torch.float64, device="cpu") for s in (1, 2))
    assert np.array_equal(p.obs_cam, q.obs_cam) and np.array_equal(p.obs_pt, q.obs_pt)
    assert not torch.equal(p.points, q.points)
    r = synthetic_bal(C, P, O, seed=1, dtype=torch.float64, device="cpu")
    assert not np.array_equal(p.obs_pt, r.obs_pt)
    with pytest.raises(ValueError, match="families"):
        build_ba_objective(p, dtype=torch.float64, device="cpu", use_families=False, optimize_intrinsics=True)


def test_build_without_intrinsics_is_unchanged():
    prob = synthetic_ba(5, 24, batch=2, seed=0, visibility=0.6, dtype=torch.float64, device="cpu")
    out = build_ba_objective(prob, dtype=torch.float64, device="cpu")
    assert len(out) == 3
    obj, cams, pts = out
    co = obj.compile()
    assert all(n.startswith(("cam[", "pt[")) for n in co.var_names)
    cost = next(b for b in co.buckets if b.name.endswith("obs")).template
    assert not cost.optimize_intrinsics and len(cost.optim_vars) == 2 and len(cost.aux_vars) == 4
    assert set(ba_values(prob)) == {"cam", "pt"}
    bld = SchurNormalBuilder(co, eliminate_landmarks(pts))
    assert (bld.n_cams, bld.cam_d) == (5, 6)
    # the per-cost build names the same variables, one by one
    obj1, _, _ = build_ba_objective(prob, dtype=torch.float64, device="cpu", use_families=False)
    assert len(obj1.compile().var_names) == len(co.var_names)


def test_generator_keeps_the_counts_and_the_track_rule():
    prob = _problem(seed=5)
    k = np.bincount(prob.obs_pt, minlength=P)
    assert (prob.num_cameras, prob.num_points, len(prob.obs_cam)) == (C, P, O)
    assert k.min() >= 2 and k.max() <= C and k.sum() == O
    assert len(set(zip(prob.obs_cam.tolist(), prob.obs_pt.tolist()))) == O  # distinct cameras per track
    assert np.all(np.diff(prob.obs_cam) >= 0)  # camera-major, as BAL lists them
    pose, pt = prob.gt_poses[prob.obs_cam], prob.gt_points[prob.obs_pt]
    p_cam = (pose[..., :3] @ pt[..., None])[..., 0] + pose[..., 3]
    assert bool((p_cam[..., 2] < 0).all())  # every point ahead of every camera
    assert tuple(prob.intrinsics.shape) == (C, B, 3) and tuple(prob.gt_intrinsics.shape) == (C, B, 3)


def test_bal_file_carries_the_intrinsics(tmp_path):
    path = tmp_path / "tiny.txt"
    cams = [[0.01, -0.02, 0.03, 0.1, 0.2, -12.0, 900.0, -0.1, 0.02],
            [0.02, 0.01, -0.01, -0.1, 0.1, -11.0, 1100.0, 0.05, -0.01]]
    pts = [[0.5, 0.1, 0.2], [-0.3, 0.4, 0.0], [0.1, -0.2, 0.3]]
    obs = [(0, 0, 10.5, -3.25), (1, 0, 11.0, -2.5), (0, 1, -7.0, 8.0), (1, 2, 1.5, 2.0), (0, 2, 0.25, 1.0)]
    with open(path, "w") as fh:
        fh.write(f"2 3 {len(obs)}\n")
        fh.writelines(f"{c} {p} {x} {y}\n" for c, p, x, y in obs)
        fh.writelines(f"{v}\n" for row in cams + pts for v in row)
    prob = load_bal(path, dtype=torch.float64, device="cpu")
    want = torch.tensor([c[6:] for c in cams], dtype=torch.float64)[:, None]
    assert torch.equal(prob.intrinsics, want)
    obj, _, _, intr = build_ba_objective(prob, dtype=torch.float64, device="cpu", optimize_intrinsics=True)
    vals = ba_values(prob, optimize_intrinsics=True)
    assert intr.name == "intr" and torch.equal(vals["intr"], want)
    # a solved problem's intrinsics go back into the file
    moved = prob.with_intrinsics(want * torch.tensor([1.01, 0.5, 2.0], dtype=torch.float64))
    save_bal(tmp_path / "out.txt", moved)
    back = load_bal(tmp_path / "out.txt", dtype=torch.float64, device="cpu")
    torch.testing.assert_close(back.intrinsics, moved.intrinsics, rtol=1e-15, atol=0)
    torch.testing.assert_close(back.points, prob.points, rtol=1e-15, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("shape", [(301, 7), (40000, 2)])
def test_intrinsics_kernel_matches_twin(dtype, shared, shape):
    """On the card; relative to the largest of each output (errors and the
    intrinsics' and pose's jacobians carry f, ~1e3). 40000 x 2 items keep
    the block at 256 threads, where float64's tile (61,440 bytes) takes the
    launcher's opt-in past 48 KB."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    ops = list(_inputs(K=shape[0], batch=shape[1], seed=2, dtype=dtype, device=dev))
    if shared:
        ops[3] = ops[3][0]  # one feature (B, 2) for every observation: a zero k stride
    _cuda.reset_launches()
    got = reprojection_intr_linearize(*ops)
    assert _cuda.launches["reprojection_intr"] == 1
    with config.plain_path():
        want = reprojection_intr_linearize(*ops)
    torch.cuda.synchronize()
    tol = {torch.float32: 2e-5, torch.float64: 1e-11}[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol * float(w.abs().max()), rtol=tol)
