"""The Schur-complement backend of theseus_tpu_torch against the JAX package, on the CPU.

Mirrors tests/optim/test_schur.py. A small bundle-adjustment problem is made
by the JAX package (its synthetic_ba, float64) and carried into the port
with utils/convert.py; both add the same scale pin on landmark 0 (without
it the reduced camera system is singular at zero damping). The port's
Schur step is then held to JAX's on the very same assembled AtA (the JAX
one, fed to the port): 1e-9 relative, float64, on both elimination paths
(dense W, and the pair sum's path that a zero budget forces, its "chunked"
cases).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu import config as jconfig
from theseus_tpu.optim.schur import SchurNormalBuilder as JSchurBuilder
from theseus_tpu.optim.schur import eliminate_points as jeliminate
from theseus_tpu.utils.examples.bundle_adjustment import (
    ba_values as jba_values,
    build_ba_objective as jbuild,
    synthetic_ba as jsynthetic,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.optim import schur, schur_pairs
from theseus_tpu_torch.optim.schur import SchurNormal, SchurNormalBuilder, eliminate_points
from theseus_tpu_torch.utils.convert import ba_problem_from_arrays
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective

RTOL = 1e-9


@functools.lru_cache(maxsize=None)
def _problems(seed=0, batch=2, cams=5, pts=24, visibility=0.6):
    """(JAX (objective, values), port (objective, values)) of one problem.
    Cached: the objectives are only read."""
    jp = jsynthetic(num_cameras=cams, num_points=pts, batch=batch, seed=seed,
                    visibility=visibility, dtype=jnp.float64)
    jobj, _, jpts = jbuild(jp, gauge_target=jp.gt_poses[0])
    jobj.add(jt.Local(jpts[0], jp.gt_points[0], jt.ScaleCostWeight(jnp.asarray(10.0, jnp.float64)),
                      name="scale_pin"))
    keys = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img",
            "gt_poses", "gt_points")
    prob = ba_problem_from_arrays({k: np.asarray(getattr(jp, k)) for k in keys}, dtype=torch.float64, device="cpu")
    obj, _, pts_ = build_ba_objective(prob, dtype=torch.float64, device="cpu", gauge_target=prob.gt_poses[0])
    obj.add(tt.Local(pts_[0], prob.gt_points[0].numpy(), tt.ScaleCostWeight(10.0), name="scale_pin"))
    return (jobj, jobj.default_values(jba_values(jp))), (obj, obj.default_values(ba_values(prob)))


@functools.lru_cache(maxsize=None)
def _systems(**kw):
    """Both packages' Schur normal systems; the port's built on JAX's AtA.
    Cached: the systems are only read."""
    (jobj, jvals), (obj, vals) = _problems(**kw)
    jco, co = jobj.compile(), obj.compile()
    b = jco.resolve_batch_size(jvals)
    jns = JSchurBuilder(jco, jeliminate).build(jco.pack(jvals, b), jco.build_aux(jvals, b))
    bld = SchurNormalBuilder(co, eliminate_points)
    assert bld.pattern.pair_slot == JSchurBuilder(jco, jeliminate).pattern.pair_slot
    ns = SchurNormal(bld, torch.as_tensor(np.array(jns.ata)), torch.as_tensor(np.array(jns.atb_blocks)))
    own = bld.build(co.pack(vals, b), co.build_aux(vals, b))
    return jns, ns, own


@pytest.fixture
def budget():
    """Set both packages' dense-elimination budget; restored afterwards."""
    old = (jconfig.SCHUR_DENSE_BUDGET_BYTES, config.SCHUR_DENSE_BUDGET_BYTES)

    def set_(nbytes):
        jconfig.set_schur_dense_budget(nbytes)
        config.set_schur_dense_budget(nbytes)

    yield set_
    jconfig.set_schur_dense_budget(old[0])
    config.set_schur_dense_budget(old[1])


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = max(1e-300, float(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= rtol * scale, np.abs(got.numpy() - want).max() / scale


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("damping,ellipsoidal", [(0.0, False), (1e-2, False), (1e-3, True)])
def test_schur_step_matches_jax(budget, path, damping, ellipsoidal):
    if path == "chunked":
        budget(0)
    jns, ns, _ = _systems()
    jd, jbad = jns.solve(damping, ellipsoidal)
    d, bad = ns.solve(damping, ellipsoidal)
    assert not bad.any() and not np.asarray(jbad).any()
    _close(d, jd)


def test_rhs_shift_matches_jax():
    jns, ns, _ = _systems(seed=2)
    shift = np.random.default_rng(0).standard_normal(tuple(ns.Atb.shape))
    jd, _ = jns.solve(1e-3, False, rhs_shift=jnp.asarray(shift))
    d, _ = ns.solve(1e-3, False, rhs_shift=torch.as_tensor(shift))
    _close(d, jd)


def test_assembled_system_matches_jax():
    """Reprojection family linearization + block assembly in the port give
    JAX's AtA and Atb (1e-12 of the scale: same formulas, float64)."""
    jns, ns, own = _systems(seed=1)
    _close(own.ata, jns.ata, 1e-12)
    _close(own.atb_blocks, jns.atb_blocks, 1e-12)


def test_quad_and_diag_match_jax():
    jns, ns, _ = _systems()
    v = np.random.default_rng(1).standard_normal(tuple(ns.Atb.shape))
    _close(ns.quad(torch.as_tensor(v)), jns.quad(jnp.asarray(v)), 1e-12)
    _close(ns.diag(), jns.diag(), 0.0)


@pytest.mark.parametrize("chunk_points", [None, 3])
def test_dense_and_chunked_elimination_agree(budget, monkeypatch, chunk_points):
    """Within the port: the pair sum's plain twin (in one piece, or 3
    entries at a time, with the segment sums as scatter-adds over repeated
    cameras) gives the dense path's step."""
    _, ns, _ = _systems()
    dense, _ = ns.solve(1e-3, False)
    budget(0)
    if chunk_points is not None:
        monkeypatch.setattr(schur_pairs, "PLAIN_ENTRIES", chunk_points)
        monkeypatch.setattr(schur, "_ONEHOT_MAX_ELEMS", 0)
        assert ns.builder.pair_counts()[0] > chunk_points
    chunked, _ = ns.solve(1e-3, False)
    _close(chunked, dense.numpy())


def _two_groups(seed=0, cams=7, pts=40):
    """Couplings (cam, pt) of cameras 0-3 seeing points 0-19 and cameras
    4-6 seeing the rest, 1 to 4 cameras a point: no camera of one group
    shares a point with one of the other."""
    rng = np.random.default_rng(seed)
    cam, pt = [], []
    for p in rng.permutation(pts):
        group = np.arange(4) if p < pts // 2 else np.arange(4, cams)
        seen = rng.choice(group, size=int(rng.integers(1, len(group) + 1)), replace=False)
        cam += seen.tolist()
        pt += [int(p)] * len(seen)
    return np.asarray(cam), np.asarray(pt), cams


@pytest.mark.parametrize("case", ["ba", "two_groups"])
def test_pair_table_lists_each_camera_pairs_shared_points(case):
    """Every entry of the pair table is a point that both cameras of its
    segment see, each segment lists all of them in point order, a pair
    that shares no point has no segment, and the entries number the sum
    over points of k^2 (pair_counts()'s useful pairs)."""
    if case == "ba":
        (_, _), (obj, _) = _problems()
        bld = SchurNormalBuilder(obj.compile(), eliminate_points)
        cam, pt, n_cams = bld.cp_cam, bld.cp_pt, bld.n_cams
        assert bld.pair_counts()[0] == int((np.bincount(pt) ** 2).sum())
    else:
        cam, pt, n_cams = _two_groups()
    t = schur_pairs.pair_table(cam, pt, n_cams)
    ptr, blk, obs = t["ptr"], t["blk"], t["obs"]
    assert obs.shape == (int((np.bincount(pt) ** 2).sum()), 2) and ptr[-1] == len(obs)
    sees = {}
    for o, (c, p) in enumerate(zip(cam, pt)):
        sees.setdefault(int(c), {})[int(p)] = o
    want = {}
    for a in sorted(sees):
        for b in sorted(sees):
            shared = sorted(set(sees[a]) & set(sees[b]))
            if shared:
                want[(a, b)] = [(sees[a][p], sees[b][p]) for p in shared]
    got = {(int(a), int(b)): [tuple(e) for e in obs[lo:hi].tolist()]
           for (a, b), lo, hi in zip(blk, ptr[:-1], ptr[1:])}
    assert got == want and list(got) == list(want)  # in (a, b) order
    if case == "two_groups":
        assert (0, 4) not in got and (6, 3) not in got and len(got) == 4 * 4 + 3 * 3
    lens = np.diff(ptr)[t["order"]]
    assert sorted(t["order"].tolist()) == list(range(len(blk))) and (np.diff(lens) <= 0).all()


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_mixed_dof_slice_equivalence(budget, path):
    """Cameras at dof 6 and points at dof 3 (the sliced elimination) give
    the step of the uniform pad d = 6 on both axes."""
    if path == "chunked":
        budget(0)
    (_, _), (obj, vals) = _problems(seed=3)
    co = obj.compile()
    state, aux = co.pack(vals, 2), co.build_aux(vals, 2)
    bld = SchurNormalBuilder(co, eliminate_points)
    assert bld.pt_d < bld.pattern.d
    sliced, _ = bld.build(state, aux).solve(1e-3, False)
    bld_u = SchurNormalBuilder(co, eliminate_points)
    bld_u.pt_d = bld_u.cam_d = bld_u.pattern.d
    uniform, _ = bld_u.build(state, aux).solve(1e-3, False)
    _close(sliced, uniform.numpy())


def test_non_positive_definite_system_is_bad_with_zero_step():
    """A reduced camera system that is not positive definite: the batch
    element is flagged and its step is zero, as in JAX; the other element
    solves normally."""
    jns, ns, _ = _systems()
    ata = np.array(jns.ata)
    ata[1 + 1, 0] = -1e6 * np.eye(6)  # camera 1's diagonal block, batch element 0
    jns2 = type(jns)(jns.builder, jnp.asarray(ata), jns.atb_blocks)
    ns2 = SchurNormal(ns.builder, torch.as_tensor(ata), ns.atb_blocks)
    jd, jbad = jns2.solve(0.0, False)
    d, bad = ns2.solve(0.0, False)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(jbad))
    assert bad.tolist() == [True, False]
    assert (d[0] == 0).all() and torch.isfinite(d).all()
    _close(d[1:], np.asarray(jd)[1:])


def test_coupled_landmarks_are_rejected():
    p1, p2 = tt.Point3(name="a"), tt.Point3(name="b")
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(tt.Between(p1, p2, np.zeros((1, 3))))
    with pytest.raises(ValueError, match="coupling two eliminated"):
        SchurNormalBuilder(obj.compile(), eliminate_points)


def test_nothing_to_eliminate_is_rejected():
    (_, _), (obj, _) = _problems()
    with pytest.raises(ValueError, match="nothing to eliminate"):
        SchurNormalBuilder(obj.compile(), lambda name, group: False)


def test_eliminate_predicate_reaches_the_builder():
    (_, _), (obj, _) = _problems()
    opt = tt.LevenbergMarquardt(obj, linearization="schur",
                                eliminate=lambda name, group: name.startswith("pt[1"))
    bld = opt.normal_builder
    names = [obj.compile().var_names[i] for i in bld.pt_vars]
    assert names and all(n.startswith("pt[1") for n in names)


def test_refinement_tier_moves_float32_step_toward_float64():
    """With the high-precision tier on, a float32 Schur step is refined in
    float64 around the float32 factor (the sparse backend's contract)."""
    jns, ns, _ = _systems(seed=4)
    want, _ = ns.solve(1e-3, False)
    ns32 = SchurNormal(ns.builder, ns.ata.float(), ns.atb_blocks.float())
    plain, _ = ns32.solve(1e-3, False)
    config.set_high_precision_tier(True)
    try:
        refined, _ = ns32.solve(1e-3, False)
    finally:
        config.set_high_precision_tier(False)
    err = lambda d: float((d.double() - want).abs().max())  # noqa: E731
    assert err(refined) < err(plain)


def test_schur_lm_reduces_error():
    (_, _), (obj, vals) = _problems(seed=1, batch=2)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True,
                                                  linearization="schur"))
    _, info = layer.forward(vals)
    assert (info.last_err < 1e-4 * info.err_history[0]).all()
