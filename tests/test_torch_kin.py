"""Kinematics of theseus_tpu_torch against the JAX package, on the CPU, in float64.

- `parse_urdf` and `Robot` on every URDF of tests/kin/*.py and the 7-dof
  serving arm (fixed, mimic, prismatic and revolute joints): the same joint
  specs, dofs, limits, offsets and ancestor chains;
- `fk`, `jfk_b` and `jfk_s` against the JAX package: 1e-12; torch.func.jacfwd
  of fk (through the SE3 local) against `jfk_b`, and the spatial jacobian
  against Adj(pose) jfk_b, as tests/kin/test_fk.py asserts;
- the IK of tests/kin/test_ik.py through the dense path: the batched solve
  against the JAX layer (1e-8) and its implicit outer gradient with respect
  to the target (1e-8);
- the 7-dof serving IK at batch 8 from zero, 12 LM iterations: the final
  joint angles against the JAX package's, 1e-9;
- in float32 the 7-dof arm (redundant: 7 joints for a 6-dof pose) reaches
  the same pose error as float64 but another point of its solution set; the
  JAX package's float32 solve does the same (printed with -s).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu import kin as jkin
from theseus_tpu import lie as jlie
import theseus_tpu_torch as tt
from theseus_tpu_torch import kin
from theseus_tpu_torch.lie import SE3, se3
from theseus_tpu_torch.utils.examples.inverse_kinematics import ARM_7DOF, IK_ITERS, build_ik_layer

KIN_TESTS = Path(__file__).resolve().parent / "kin"


def _module(name):
    spec = importlib.util.spec_from_file_location(f"_kin_{name}", KIN_TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_fk_mod, _ik_mod, _mimic_mod = _module("test_fk"), _module("test_ik"), _module("test_mimic")
URDFS = {
    "arm2_fixed": _fk_mod.ARM_URDF,
    "mixed_prismatic": _fk_mod.MIXED_URDF,
    "arm4": _ik_mod.URDF,
    "gripper_mimic": _mimic_mod.GRIPPER_URDF,
    "gripper_explicit": _mimic_mod.EXPLICIT_URDF,
    "arm7": ARM_7DOF,
}


def _links(robot):
    return sorted(robot._offset_of_link)


@pytest.mark.parametrize("name", list(URDFS))
def test_robot_matches_jax(name):
    robot, jrobot = kin.Robot.from_urdf_string(URDFS[name]), jkin.Robot.from_urdf_string(URDFS[name])
    assert robot.dof == jrobot.dof and robot.joint_names == jrobot.joint_names
    assert robot.base_link == jrobot.base_link and sorted(robot.link_names) == sorted(jrobot.link_names)
    for s, js in zip(robot.joints, jrobot.joints, strict=True):
        assert (s.name, s.kind, s.parent_link, s.child_link, s.index, s.dof_index, s.parent_joint,
                s.mimic_of, s.mimic_mult, s.mimic_off) == (js.name, js.kind, js.parent_link, js.child_link,
                                                            js.index, js.dof_index, js.parent_joint,
                                                            js.mimic_of, js.mimic_mult, js.mimic_off)
        np.testing.assert_array_equal(s.axis, js.axis)
        np.testing.assert_array_equal(s.origin, js.origin)
    np.testing.assert_array_equal(robot.joint_limits, jrobot.joint_limits)
    np.testing.assert_array_equal(robot.velocity_limits, jrobot.velocity_limits)
    for link in _links(jrobot):
        np.testing.assert_array_equal(robot.link_offset(link), jrobot.link_offset(link))
        assert robot.link_parent_joint(link) == jrobot.link_parent_joint(link)
        assert robot.ancestor_joints(link) == jrobot.ancestor_joints(link)
    parsed, jparsed = kin.parse_urdf(URDFS[name], from_string=True), jkin.parse_urdf(URDFS[name], from_string=True)
    assert dataclasses.asdict(parsed) == dataclasses.asdict(jparsed)


def test_urdf_helpers_and_mimic_errors():
    from theseus_tpu.kin import urdf as jurdf

    rpy = (0.3, -0.4, 1.1)
    np.testing.assert_array_equal(kin.rpy_to_matrix(rpy), jurdf.rpy_to_matrix(rpy))
    (joint,) = [j for j in kin.parse_urdf(_fk_mod.MIXED_URDF, from_string=True).joints if j.name == "jx"]
    np.testing.assert_array_equal(kin.origin_pose(joint), jurdf.origin_pose(joint))
    chained = _mimic_mod.GRIPPER_URDF.replace("</robot>", """
      <link name="f3"/>
      <joint name="finger3" type="prismatic">
        <parent link="palm"/><child link="f3"/><axis xyz="1 0 0"/>
        <mimic joint="finger2"/>
      </joint></robot>""")
    with pytest.raises(ValueError, match="itself a mimic"):
        kin.Robot.from_urdf_string(chained)
    with pytest.raises(ValueError, match="unknown joint"):
        kin.Robot.from_urdf_string(_mimic_mod.GRIPPER_URDF.replace('joint="finger1"', 'joint="nope"'))


@pytest.mark.parametrize("name", list(URDFS))
def test_fk_and_jacobians_match_jax(name):
    robot, jrobot = kin.Robot.from_urdf_string(URDFS[name]), jkin.Robot.from_urdf_string(URDFS[name])
    links = _links(jrobot)
    fns = kin.get_forward_kinematics_fns(robot, links)
    jfns = jkin.get_forward_kinematics_fns(jrobot, links)
    th = np.random.default_rng(0).standard_normal((3, 2, robot.dof))
    poses, jposes = fns[0](torch.as_tensor(th)), jfns[0](jnp.asarray(th))
    for p, jp in zip(poses, jposes, strict=True):
        assert p.shape == (3, 2, 3, 4)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-12, atol=1e-12)
    for fn, jfn in zip(fns[1:], jfns[1:]):
        (jacs, poses), (jjacs, jposes) = fn(torch.as_tensor(th)), jfn(jnp.asarray(th))
        for j, jj in zip(jacs, jjacs, strict=True):
            assert j.shape == (3, 2, 6, robot.dof)
            np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["arm2_fixed", "mixed_prismatic", "gripper_mimic", "arm7"])
def test_jacfwd_of_fk_equals_body_jacobian(name):
    robot = kin.Robot.from_urdf_string(URDFS[name])
    link = robot.joints[-1].child_link
    fk, jfk_b, jfk_s = kin.get_forward_kinematics_fns(robot, [link])
    th = torch.as_tensor(np.random.default_rng(1).standard_normal(robot.dof))
    (jac,), (pose,) = jfk_b(th)
    (jac_s,), _ = jfk_s(th)
    num = torch.func.jacfwd(lambda t: SE3.local(pose, fk(t)[0]))(th)
    np.testing.assert_allclose(jac.numpy(), num.numpy(), atol=1e-9)
    np.testing.assert_allclose(jac_s.numpy(), (se3.adjoint(pose) @ jac).numpy(), atol=1e-9)


def test_fk_constants_built_once_per_device_and_dtype():
    robot = kin.Robot.from_urdf_string(ARM_7DOF)
    fk, _, _ = kin.get_forward_kinematics_fns(robot, ["ee"])
    cells = list(fk.__closure__)
    while not any(isinstance(c.cell_contents, kin.fk._Tables) for c in cells):
        cells = [d for c in cells if callable(c.cell_contents) and c.cell_contents.__closure__
                 for d in c.cell_contents.__closure__]
    tables = next(c.cell_contents for c in cells if isinstance(c.cell_contents, kin.fk._Tables))
    for _ in range(3):
        fk(torch.zeros(4, robot.dof, dtype=torch.float64))
        torch.func.vmap(fk)(torch.zeros(4, robot.dof, dtype=torch.float64))
    fk(torch.zeros(robot.dof, dtype=torch.float32))
    assert len(tables._on) == 2


# ---------------------------------------------------------------------------
# inverse kinematics through the layer
# ---------------------------------------------------------------------------
def _ik4(jax_side, batch, mode="fwd"):
    if jax_side:
        return _ik_mod._setup(batch)
    return build_ik_layer(torch.float64, "cpu", iters=40, urdf=_ik_mod.URDF, autograd_mode=mode,
                          linearization="dense")


def test_ik4_converges_as_jax():
    jlayer, jfk, jtargets, jrobot = _ik4(True, 2)
    init = np.array([[0.4, -0.6, 0.8, 0.3], [-0.2, 0.5, -0.7, 0.9]]) + 0.25
    jout, jinfo = jlayer.forward({"theta": jnp.asarray(init)})
    layer, fk, robot = _ik4(False, 2)
    out, info = layer.forward({"theta": init, "target": np.asarray(jtargets)})
    np.testing.assert_allclose(out["theta"].numpy(), np.asarray(jout["theta"]), rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(info.status.numpy(), np.asarray(jinfo.status))
    assert (info.status.numpy() == tt.NonlinearOptimizerStatus.CONVERGED).all()
    err = SE3.local(torch.as_tensor(np.asarray(jtargets)), fk(out["theta"])[0])
    assert float(err.abs().max()) < 1e-6


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_ik4_implicit_outer_gradient_matches_jax(mode):
    """d sum(theta*^2) / d target (raw (3, 4) coordinates), implicit mode:
    the jacobian's own derivative enters through Atb, through the Lie rules'
    jvp (fwd) or backward (rev)."""
    jlayer, _, jtargets, _ = _ik4(True, 1)

    def jsolve(tgt):
        out, _ = jlayer.forward({"theta": jnp.zeros((1, 4), jnp.float64), "target": tgt},
                                {"backward_mode": "implicit"})
        return jnp.sum(out["theta"] ** 2)

    want = np.asarray(jax.grad(jsolve)(jtargets[:1]))
    layer, _, _ = _ik4(False, 1, mode)
    tgt = torch.as_tensor(np.asarray(jtargets[:1])).requires_grad_(True)
    out, _ = layer.forward({"theta": np.zeros((1, 4)), "target": tgt}, {"backward_mode": "implicit"})
    (g,) = torch.autograd.grad(torch.sum(out["theta"] ** 2), tgt)
    assert np.isfinite(g.numpy()).all() and np.abs(g.numpy()).sum() > 1e-6
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-8, atol=1e-8 * np.abs(want).max())


def _jax_ik7(targets, dtype):
    jrobot = jkin.Robot.from_urdf_string(ARM_7DOF)
    jfk, _, _ = jkin.get_forward_kinematics_fns(jrobot, ["ee"])
    b = targets.shape[0]

    def ik_err(optim, aux):
        (th,) = optim
        (tgt,) = aux
        (pose,) = jfk(th)
        return jlie.SE3.local(tgt, pose)

    obj = jt.Objective(dtype=dtype)
    obj.add(jt.AutoDiffCostFunction([jt.Vector(7, name="theta")], 6, ik_err,
                                    aux_vars=[jt.Variable(jnp.zeros((b, 3, 4), dtype), name="target")], name="ik"))
    layer = jt.TheseusLayer(jt.LevenbergMarquardt(obj, max_iterations=IK_ITERS, adaptive_damping=True))
    out, info = layer.forward({"theta": jnp.zeros((b, 7), dtype), "target": jnp.asarray(targets, dtype)})
    return np.asarray(out["theta"], np.float64), info


def _ik7_targets(batch, seed=0):
    robot = kin.Robot.from_urdf_string(ARM_7DOF)
    fk, _, _ = kin.get_forward_kinematics_fns(robot, ["ee"])
    th = 0.7 * np.random.default_rng(seed).standard_normal((batch, 7))
    return fk(torch.as_tensor(th))[0].numpy()


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_ik7_serving_solve_matches_jax(mode):
    """The serving IK (jacrev by default) and its jacfwd variant against the
    JAX package's (jacfwd), same targets, batch 8."""
    targets = _ik7_targets(8)
    want, jinfo = _jax_ik7(targets, jnp.float64)
    layer, _, _ = build_ik_layer(torch.float64, "cpu", autograd_mode=mode)
    out, info = layer.forward({"theta": np.zeros((8, 7)), "target": targets})
    np.testing.assert_allclose(out["theta"].numpy(), want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(info.last_err.numpy(), np.asarray(jinfo.last_err), rtol=1e-6, atol=1e-18)


def test_ik7_float32_reaches_float64_pose_error_as_jax(capsys):
    """The 7-dof arm is redundant: its AtA (7 x 7, rank 6) has a null
    direction that only the damping (down to 1e-7) bounds, and float32
    rounding of AtA and Atb gives each step a null-space part of order
    eps_f32 / damping. Float32 therefore ends at another point of the
    solution set than float64 while reaching the same pose error; the JAX
    package's float32 solve does the same on the same targets."""
    b = 64
    targets = _ik7_targets(b, seed=1)
    spread = {}
    for side in ("jax", "port"):
        thetas, errs = {}, {}
        for dt in ("float32", "float64"):
            if side == "jax":
                th, info = _jax_ik7(targets, getattr(jnp, dt))
                errs[dt] = np.asarray(info.last_err, np.float64)
            else:
                layer, _, _ = build_ik_layer(getattr(torch, dt), "cpu")
                out, info = layer.forward({"theta": np.zeros((b, 7)), "target": targets})
                th, errs[dt] = out["theta"].double().numpy(), info.last_err.double().numpy()
            thetas[dt] = th
        d = np.abs(thetas["float32"] - thetas["float64"]).max(-1)
        # task space: the residual norm sqrt(2 err) in float32 against float64
        task = np.abs(np.sqrt(2 * errs["float32"]) - np.sqrt(2 * errs["float64"]))
        spread[side] = (int((d > 1e-2).sum()), float(np.median(d)), int((task > 1e-2).sum()))
    with capsys.disabled():
        print(f"\n[ik7 float32 vs float64, batch {b}] (joint-space basins > 1e-2, median joint diff, "
              f"task-space basins > 1e-2): JAX {spread['jax']}, port {spread['port']}")
    for side in ("jax", "port"):
        assert spread[side][2] <= 1, spread  # the same pose error, but for at most one element
    assert spread["port"][0] <= 2 * spread["jax"][0] + 2, spread
