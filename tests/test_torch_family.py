"""Variable and cost families of theseus_tpu_torch: against the per-cost objective, and the compiled layout against the JAX package's, on the CPU.

A CostFamily must be the same objective as its N costs added one by one:
equal errors and linearizations (the same float64 arithmetic in the same
observation order: 1e-12 relative), every instance reading the same
variables. Its compiled layout (variable order, type stacks, bucket index
and column tables, stacked aux slots) must equal the JAX package's, which
is what lets the two packages exchange AtA slot for slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.utils.examples.bundle_adjustment import (
    build_ba_objective as jbuild,
    synthetic_ba as jsynthetic,
)
import theseus_tpu_torch as tt
from theseus_tpu_torch.core import CostFamily, Point3Family, SE3Family, VariableFamily
from theseus_tpu_torch.utils.convert import ba_problem_from_arrays
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective, synthetic_ba

KEYS = ("poses", "points", "focals", "k1", "k2", "obs_cam", "obs_pt", "obs_img")


def _port_problem(use_families, C=5, P=30, B=2, seed=0):
    prob = synthetic_ba(C, P, batch=B, seed=seed, visibility=0.5, dtype=torch.float64, device="cpu")
    prob.k1 = 0.05 * torch.ones_like(prob.k1)  # exercise the distortion terms
    obj, cams, pts = build_ba_objective(prob, dtype=torch.float64, device="cpu", use_families=use_families)
    co = obj.compile()
    vals = obj.default_values(ba_values(prob, use_families))
    return prob, obj, co, co.pack(vals, B), co.build_aux(vals, B)


def _rel(a, b):
    return float((a - b).abs().max()) / max(1e-300, float(b.abs().max()))


def test_family_objective_equals_per_cost_objective():
    _, _, fco, fstate, faux = _port_problem(True)
    _, _, pco, pstate, paux = _port_problem(False)
    assert len(fco.buckets) == len(pco.buckets) == 2
    assert fco.total_dim == pco.total_dim and fco.total_dof == pco.total_dof
    assert _rel(fco.error(fstate, faux), pco.error(pstate, paux)) <= 1e-12
    for (fj, fe), (pj, pe) in zip(fco.linearize_blocks(fstate, faux), pco.linearize_blocks(pstate, paux)):
        assert _rel(fe, pe) <= 1e-12
        for a, b in zip(fj, pj):
            assert _rel(a, b) <= 1e-12


def test_family_instances_read_the_same_variables():
    """Bucket idx/cols of the family map, name by name, onto the per-cost
    objective's (family member cam[i] <-> variable cam_i)."""
    _, _, fco, _, _ = _port_problem(True)
    _, _, pco, _, _ = _port_problem(False)

    def rename(n):
        return n.replace("[", "_").rstrip("]")

    for fb, pb in zip(fco.buckets, pco.buckets):
        assert fb.k == pb.k
        for fs, ps in zip(fb.optim_slots, pb.optim_slots):
            fnames = [rename(fco.type_members[fs.type_key][i]) for i in fs.idx]
            pnames = [pco.type_members[ps.type_key][i] for i in ps.idx]
            assert fnames == pnames
            for row_f, row_p, n in zip(fs.cols, ps.cols, pnames):
                fvar = fco.var_names[np.searchsorted(np.cumsum([fco.var_groups[v].dof for v in fco.var_names]), row_f[0], "right")]
                assert rename(fvar) == n
                assert row_f[-1] - row_f[0] == row_p[-1] - row_p[0] == fs.dof - 1


def test_gauge_on_a_family_member_maps_to_the_family_rows():
    _, _, co, _, _ = _port_problem(True)
    gauge = co.buckets[0]
    assert gauge.k == 1
    (slot,) = gauge.optim_slots
    assert slot.type_key == "SE3" and list(slot.idx) == [0] and list(slot.cols[0]) == list(range(6))
    obs = co.buckets[1]
    assert obs.count == obs.k and obs.cfs == ()
    assert all(s.stacked for s in obs.aux_slots) and not any(s.stacked for s in obs.weight_slots)


def test_compiled_layout_matches_jax():
    jp = jsynthetic(num_cameras=4, num_points=20, batch=2, seed=1, visibility=0.6, dtype=jnp.float64)
    prob = ba_problem_from_arrays({k: np.asarray(getattr(jp, k)) for k in KEYS}, dtype=torch.float64, device="cpu")
    for fam in (True, False):
        jco = jbuild(jp, dtype=jnp.float64, use_families=fam)[0].compile()
        co = build_ba_objective(prob, dtype=torch.float64, device="cpu", use_families=fam)[0].compile()
        assert co.var_names == jco.var_names
        assert co.type_members == jco.type_members
        assert co.col_offset == jco.col_offset
        assert co.stacked_names == jco.stacked_names
        for b, jb in zip(co.buckets, jco.buckets):
            assert (b.k, b.dim, b.row_offset) == (jb.k, jb.dim, jb.row_offset)
            for s, js in zip(b.optim_slots, jb.optim_slots):
                assert (s.type_key, s.dof, s.shared) == (js.type_key, js.dof, js.shared)
                np.testing.assert_array_equal(s.idx, js.idx)
                np.testing.assert_array_equal(s.cols, js.cols)
            for s, js in zip(b.aux_slots + b.weight_slots, jb.aux_slots + jb.weight_slots):
                # auto-generated names (default weights, gauge target) differ
                assert (len(s.names), s.shared, s.stacked) == (len(js.names), js.shared, js.stacked)
                if s.stacked:
                    assert s.names == js.names


def test_pack_unpack_and_batch_resolution():
    prob, obj, co, state, _ = _port_problem(True, B=1)
    vals = {"cam": prob.poses, "pt": prob.points.expand(-1, 3, -1)}  # cameras broadcast over batch 3
    values = obj.default_values(vals)
    assert co.resolve_batch_size(values) == 3
    st = co.pack(values)
    assert st["SE3"].shape == (5, 3, 3, 4) and st["Rn3"].shape == (30, 3, 3)
    out = co.unpack(st)
    assert set(out) == {"cam", "pt"}
    torch.testing.assert_close(out["cam"], prob.poses.expand(-1, 3, -1, -1), rtol=0, atol=0)
    torch.testing.assert_close(out["pt"], vals["pt"], rtol=0, atol=0)
    aux = co.build_aux(values, 3)
    focal, feat, k1, k2 = aux[1][0]
    assert focal.shape == (len(prob.obs_cam), 3, 1) and feat.shape == (len(prob.obs_cam), 3, 2)


def test_family_defaults_are_identities():
    fam = Point3Family(4, name="p")
    cams = SE3Family(3, name="c")
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    obj.add(tt.Local(cams[1], np.eye(3, 4)[None], name="prior"))
    obj.add(tt.Local(fam[2], np.ones((1, 3)), name="pp"))
    vals = obj.default_values()
    assert set(obj.var_families) == {"c", "p"} and not obj.optim_vars
    assert vals["p"].shape == (4, 1, 3) and (vals["p"] == 0).all()
    torch.testing.assert_close(vals["c"][:, 0], torch.eye(3, 4, dtype=torch.float64).expand(3, 3, 4))
    co = obj.compile()
    assert co.var_names == ("c[0]", "c[1]", "c[2]", "p[0]", "p[1]", "p[2]", "p[3]")
    state = co.pack(vals)
    assert float(co.error_metric(state, co.build_aux(vals))[0]) == pytest.approx(1.5)


def test_euclidean_costs_match_jax():
    """Between and Local over Point3 variables (the Rn group: retract
    g + delta, local b - a, identity jlog) linearize as in the JAX package;
    Between on a group other than SE3 takes the analytic jacobians."""
    import theseus_tpu as jt

    rng = np.random.default_rng(3)
    a, b, m, t = (rng.standard_normal((2, 3)) for _ in range(4))
    jobj = jt.Objective(dtype=jnp.float64)
    obj = tt.Objective(dtype=torch.float64, device="cpu")
    for pkg, o in ((jt, jobj), (tt, obj)):
        pa, pb = pkg.Point3(name="a"), pkg.Point3(name="b")
        o.add(pkg.Between(pa, pb, m, name="between"))
        o.add(pkg.Local(pa, t, pkg.ScaleCostWeight(2.0), name="prior"))
    assert tt.lie.by_name("Rn3") is obj.optim_vars["a"].group
    vals = {"a": a, "b": b}
    jco, co = jobj.compile(), obj.compile()
    jblocks = jco.linearize_blocks(jco.pack(vals, 2), jco.build_aux(vals, 2))
    blocks = co.linearize_blocks(co.pack(vals, 2), co.build_aux(vals, 2))
    for (jj, je), (pj, pe) in zip(jblocks, blocks):
        np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=0, atol=1e-15)
        for x, y in zip(pj, jj):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=0)
    np.testing.assert_allclose(blocks[0][1][0].numpy(), b - a - m, atol=1e-15)


def test_family_validation():
    cams, pts = SE3Family(3, name="c"), Point3Family(4, name="p")
    template = tt.Reprojection(cams[0], pts[0], np.ones((2, 1, 1)), np.zeros((2, 1, 2)))
    with pytest.raises(ValueError, match="one member ref per template"):
        CostFamily(template, [(cams, [0, 1])])
    with pytest.raises(ValueError, match="out of range"):
        CostFamily(template, [(cams, [0, 3]), (pts, [0, 1])])
    with pytest.raises(ValueError, match="disagree on count"):
        CostFamily(template, [(cams, [0, 1]), (pts, [0, 1, 2])])
    with pytest.raises(ValueError, match="family group"):
        CostFamily(template, [(pts, [0, 1]), (pts, [0, 1])])
    with pytest.raises(ValueError, match="at least one"):
        CostFamily(template, [cams[0], pts[0]])
    with pytest.raises(ValueError, match="count, B"):
        VariableFamily(tt.lie.SE3, 3, tensor=np.zeros((2, 1, 3, 4)))
    with pytest.raises(ValueError, match="count >= 1"):
        Point3Family(0)
    fam = CostFamily(template, [(cams, [0, 2]), (pts, [1, 3])], shared_aux=("x",))
    assert fam.count == 2 and fam.total_dim() == 4
