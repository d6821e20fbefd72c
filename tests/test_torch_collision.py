"""The collision costs of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `occupancy_to_sdf`: the same scipy transforms, so the same array exactly
  (a random map, an all-free and an all-occupied one).
- `sdf_signed_distance`: value and gradient (torch.func.grad against
  jax.grad) at random points, at points exactly on cell boundaries (row
  and column integers: floor is exact there and both packages take the same
  one-sided cell), on the map's last row and column, and out of bounds
  (zero distance, zero gradient): 1e-12.
- `Collision2D` (Point2 and SE2 poses) and `EffectorObjectContactPlanar`:
  the dense weighted jacobian (autodiff in both packages: jacfwd through
  the retract), b and the error metric, 1e-12 relative to max(1, |A|), at
  random points, on cell boundaries, exactly at the hinge (cost_eps equal
  to the distance, where torch.maximum and jnp.maximum both give half the
  gradient), exactly at the contact (|0|: jnp.abs's derivative there is +1,
  torch.abs's 0, so the port takes jnp's) and out of bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.embodied.collision import occupancy_to_sdf as j_occupancy_to_sdf
from theseus_tpu.embodied.collision import sdf_signed_distance as j_sdf
import theseus_tpu_torch as tt
from theseus_tpu_torch.embodied.collision import occupancy_to_sdf, sdf_signed_distance
from theseus_tpu_torch.lie import se2

H, W, CELL = 12, 10, 0.25
ORIGIN = np.array([-0.5, 0.25])
B = 2
TOL = 1e-12


def _map(seed=0):
    rng = np.random.default_rng(seed)
    occ = np.zeros((H, W))
    for _ in range(3):
        r, c = rng.integers(0, H - 3), rng.integers(0, W - 3)
        occ[r:r + 3, c:c + 2] = 1.0
    return occ


def _sdfs():
    return np.stack([occupancy_to_sdf(_map(s), CELL) for s in range(B)])


def _points(rng, n):
    """Random points inside, points on cell corners and edges (exact
    multiples of the cell from the origin), on the last row / column, and
    out of bounds on each side: (n_total, 2)."""
    inside = ORIGIN + rng.uniform(0.0, 1.0, (n, 2)) * [(W - 1) * CELL, (H - 1) * CELL]
    corners = ORIGIN + CELL * np.array([[3.0, 4.0], [0.0, 0.0], [W - 1.0, H - 1.0], [5.0, 2.5], [1.5, 7.0]])
    oob = ORIGIN + CELL * np.array([[-0.5, 3.0], [W - 0.5, 3.0], [4.0, -1.0], [4.0, H - 0.9]])
    return np.concatenate([inside, corners, oob])


@pytest.mark.parametrize("kind", ["random", "free", "occupied"])
def test_occupancy_to_sdf_exact(kind):
    occ = {"random": _map(7), "free": np.zeros((H, W)), "occupied": np.ones((H, W))}[kind]
    want = np.asarray(j_occupancy_to_sdf(occ, CELL))
    got = occupancy_to_sdf(occ, CELL)
    assert got.shape == (H, W) and np.array_equal(got, want)


def test_sdf_signed_distance_values_and_gradients():
    rng = np.random.default_rng(1)
    sdf = _sdfs()[0]
    pts = _points(rng, 12)
    cs = np.array([CELL])

    def jd(p):
        return j_sdf(jnp.asarray(sdf), jnp.asarray(ORIGIN), jnp.asarray(cs), p)[0]

    def td(p):
        return sdf_signed_distance(torch.as_tensor(sdf), torch.as_tensor(ORIGIN), torch.as_tensor(cs), p)[0]

    n_oob = 0
    for p in pts:
        jv, joob = j_sdf(jnp.asarray(sdf), jnp.asarray(ORIGIN), jnp.asarray(cs), jnp.asarray(p))
        tv, toob = sdf_signed_distance(torch.as_tensor(sdf), torch.as_tensor(ORIGIN), torch.as_tensor(cs),
                                       torch.as_tensor(p))
        assert bool(joob) == bool(toob)
        n_oob += bool(toob)
        assert abs(float(jv) - float(tv)) <= TOL * max(1.0, abs(float(jv)))
        jg = np.asarray(jax.grad(jd)(jnp.asarray(p)))
        tg = torch.func.grad(td)(torch.as_tensor(p)).numpy()
        np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL * max(1.0, np.abs(jg).max()))
        if bool(toob):
            assert float(tv) == 0.0 and not tg.any()
    assert n_oob == 4


def _objective(pkg):
    if pkg == "jax":
        return jt, jt.Objective(dtype=jnp.float64)
    return tt, tt.Objective(dtype=torch.float64, device="cpu")


def _compare(build, inputs):
    out = {}
    for pkg in ("jax", "torch"):
        obj = build(pkg)
        co = obj.compile()
        values = obj.default_values(dict(inputs))
        if pkg == "jax":
            values = {k: jnp.asarray(v) for k, v in values.items()}
        bsz = co.resolve_batch_size(values)
        state, aux = co.pack(values, bsz), co.build_aux(values, bsz)
        a, b = co.dense_A_b(state, aux)
        out[pkg] = [np.asarray(x) for x in (a, b, co.error_metric(state, aux))]
    for name, j, t in zip(("A", "b", "error"), out["jax"], out["torch"]):
        scale = max(1.0, float(np.abs(j).max()))
        assert j.shape == t.shape and np.abs(j - t).max() <= TOL * scale, (name, np.abs(j - t).max())
    return out["torch"]


def _sdf_inputs():
    return {"sdf_origin": np.tile(ORIGIN, (B, 1)), "sdf_data": _sdfs(), "cell_size": np.full((B, 1), CELL)}


@pytest.mark.parametrize("pose_kind", ["point2", "se2"])
def test_collision2d(pose_kind):
    rng = np.random.default_rng(2)
    pts = _points(rng, 6)
    k = len(pts)
    sdfs = _sdfs()
    # the hinge exactly: a corner point's distance is one map entry exactly
    hinge_pt = ORIGIN + CELL * np.array([3.0, 4.0])
    eps = np.full((k,), 0.4)
    pts[0] = hinge_pt
    eps[0] = sdfs[0][4, 3]  # batch element 0 sits on the hinge; element 1 does not
    xy = np.broadcast_to(pts[:, None], (k, B, 2)).copy()
    xy[:, 1] += 0.01 * rng.standard_normal((k, 2))
    if pose_kind == "se2":
        poses = se2.exp(torch.as_tensor(rng.standard_normal((k, B, 3)))).numpy()
        poses[..., :2] = xy
    else:
        poses = xy

    def build(pkg):
        m, obj = _objective(pkg)
        origin = m.Variable(np.zeros((1, 2)), name="sdf_origin")
        data = m.Variable(np.zeros((1, H, W)), name="sdf_data")
        cell = m.Variable(np.ones((1, 1)), name="cell_size")
        w = m.ScaleCostWeight(20.0)
        for i in range(k):
            p = m.Point2(name=f"x{i}") if pose_kind == "point2" else m.SE2(name=f"x{i}")
            obj.add(m.Collision2D(p, origin, data, cell, float(eps[i]), w, name=f"c{i}"))
        return obj

    inputs = {f"x{i}": poses[i] for i in range(k)}
    inputs.update(_sdf_inputs())
    a, b, _ = _compare(build, inputs)
    assert b[0, 0] == 0.0  # exactly at the hinge
    assert np.abs(a).max() > 0.0


def test_effector_object_contact_planar():
    rng = np.random.default_rng(3)
    k = 8
    objs = se2.exp(torch.as_tensor(0.3 * rng.standard_normal((k, B, 3)))).numpy()
    effs = se2.exp(torch.as_tensor(rng.standard_normal((k, B, 3)))).numpy()
    effs[..., :2] = ORIGIN + rng.uniform(0.2, 0.8, (k, B, 2)) * [(W - 1) * CELL, (H - 1) * CELL]
    radius = np.full((k,), 0.1)
    sdfs = _sdfs()
    # exactly at the contact: obj at the identity, eff on a cell corner
    objs[0, 0] = [0.0, 0.0, 1.0, 0.0]
    effs[0, 0, :2] = ORIGIN + CELL * np.array([2.0, 6.0])
    radius[0] = sdfs[0][6, 2]
    effs[1, 0, :2] = ORIGIN - 1.0  # out of bounds

    def build(pkg):
        m, obj = _objective(pkg)
        origin = m.Variable(np.zeros((1, 2)), name="sdf_origin")
        data = m.Variable(np.zeros((1, H, W)), name="sdf_data")
        cell = m.Variable(np.ones((1, 1)), name="cell_size")
        for i in range(k):
            obj.add(m.EffectorObjectContactPlanar(m.SE2(name=f"o{i}"), m.SE2(name=f"e{i}"), origin, data, cell,
                                                  float(radius[i]), m.ScaleCostWeight(5.0), name=f"c{i}"))
        return obj

    inputs = {f"o{i}": objs[i] for i in range(k)}
    inputs.update({f"e{i}": effs[i] for i in range(k)})
    inputs.update(_sdf_inputs())
    _, b, _ = _compare(build, inputs)
    assert b[0, 0] == 0.0
