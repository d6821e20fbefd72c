"""Tactile pose estimation: the objective, the measurement and weight models, and an outer-loop trainer (JAX counterpart: theseus_tpu/utils/examples/tactile_pose_estimation.py).

The reference's backward-mode workload (Theseus paper, Fig. 4): SE2 object
and end-effector poses over a time window, quasi-static pushing dynamics
between consecutive steps, moving-frame Between costs against learned
tactile relative measurements, effector-object contact against the object's
SDF and difference priors on the effector poses from motion capture; the
moving-frame weight comes from a learned model, and both models train by
differentiating through the inner solve.

As in the JAX package, the trainer's loss takes one ground-truth object
trajectory (T, 4) for the whole batch, and the weight model sees a constant
ones((1, 1)) input.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ... import core
from ...embodied import Difference, EffectorObjectContactPlanar, MovingFrameBetween, QuasiStaticPushingPlanar
from ...layer import TheseusLayer
from ...optim.nonlinear import LevenbergMarquardt
from ..checks import MLP, build_mlp


def measurement_windows(time_steps: int, min_w: int, max_w: int, step_w: int):
    """(i - offset, i) pairs of the moving-frame measurements."""
    pairs = []
    for i in range(min_w, time_steps):
        for offset in range(min_w, min(i, max_w), step_w):
            pairs.append((i - offset, i))
    return pairs


def _identity_se2():
    return np.array([[0.0, 0.0, 1.0, 0.0]])


class TactilePoseEstimator:
    """The objective (variables obj_pose_i, eff_pose_i; aux obj_start_pose,
    motion_capture_i, nn_measurement_a_b, sdf_data, sdf_origin,
    sdf_cell_size, eff_radius and the weights qsp_weight,
    mf_between_weight, intersect_weight, mc_weight), its optimizer
    (`optimizer_cls(objective, max_iterations=...)`) and layer."""

    def __init__(
        self,
        time_steps: int,
        min_window_moving_frame: int = 1,
        max_window_moving_frame: int = 3,
        step_window_moving_frame: int = 1,
        rectangle_shape: Tuple[float, float] = (0.1, 0.1),
        sdf_size: int = 32,
        optimizer_cls=LevenbergMarquardt,
        max_iterations: int = 3,
        dtype: torch.dtype = torch.float64,
        device=None,
    ):
        self.time_steps = time_steps
        self.pairs = measurement_windows(time_steps, min_window_moving_frame, max_window_moving_frame,
                                         step_window_moving_frame)
        obj = core.Objective(dtype=dtype, device=device)

        obj_poses = [core.SE2(name=f"obj_pose_{i}") for i in range(time_steps)]
        eff_poses = [core.SE2(name=f"eff_pose_{i}") for i in range(time_steps)]
        self.obj_poses, self.eff_poses = obj_poses, eff_poses

        start = core.Variable(_identity_se2(), name="obj_start_pose")
        mocap = [core.Variable(_identity_se2(), name=f"motion_capture_{i}") for i in range(time_steps)]
        nn_meas = {(a, b): core.Variable(_identity_se2(), name=f"nn_measurement_{a}_{b}") for (a, b) in self.pairs}
        self.sdf_data = core.Variable(np.ones((1, sdf_size, sdf_size)), name="sdf_data")
        self.sdf_origin = core.Variable(np.zeros((1, 2)), name="sdf_origin")
        self.sdf_cell_size = core.Variable(np.full((1, 1), 0.01), name="sdf_cell_size")
        eff_radius = core.Variable(np.zeros((1, 1)), name="eff_radius")

        qsp_w = core.DiagonalCostWeight(core.Variable(np.ones((1, 3)), name="qsp_weight"))
        mf_w = core.DiagonalCostWeight(core.Variable(np.ones((1, 3)), name="mf_between_weight"))
        contact_w = core.ScaleCostWeight(core.Variable(np.ones((1, 1)), name="intersect_weight"))
        mocap_w = core.DiagonalCostWeight(core.Variable(np.ones((1, 3)), name="mc_weight"))

        c_square = float(np.hypot(*rectangle_shape) ** 2)
        obj.add(Difference(obj_poses[0], start, core.ScaleCostWeight(100.0), name="obj_prior"))
        for i in range(1, time_steps):
            obj.add(QuasiStaticPushingPlanar(obj_poses[i - 1], obj_poses[i], eff_poses[i - 1], eff_poses[i],
                                             c_square, qsp_w, name=f"qsp_{i}"))
            obj.add(EffectorObjectContactPlanar(obj_poses[i], eff_poses[i], self.sdf_origin, self.sdf_data,
                                                self.sdf_cell_size, eff_radius, contact_w, name=f"contact_{i}"))
        for (a, b) in self.pairs:
            obj.add(MovingFrameBetween(obj_poses[a], obj_poses[b], eff_poses[a], eff_poses[b], nn_meas[(a, b)],
                                       mf_w, name=f"mfb_{a}_{b}"))
        for i in range(time_steps):
            obj.add(Difference(eff_poses[i], mocap[i], mocap_w, name=f"mocap_{i}"))

        self.objective = obj
        self.optimizer = optimizer_cls(obj, max_iterations=max_iterations)
        self.layer = TheseusLayer(self.optimizer)

    def forward(self, inputs: Dict, **kwargs):
        return self.layer.forward(inputs, optimizer_kwargs=kwargs)


def synthetic_push(estimator: TactilePoseEstimator, batch: int = 1, feature_dim: int = 8, seed: int = 0,
                   mocap_noise: float = 0.002, init_noise: float = 0.01, angle_noise: float = 0.02):
    """A straight +x push (the JAX package's examples/tactile_pose_estimation.py
    episode): the object moves from x = 0.1 to 0.2 m at y = 0.16 m, the
    effector trails it by 3 cm, the SDF is a 32 x 32 grid at 0.01 m with an
    0.08 m square. The batch elements differ in their motion-capture noise
    (mocap_noise m on x and y), their initial guesses (one object pose for
    every step, near the first, and each effector pose, perturbed by
    init_noise m and angle_noise rad) and their per-step features
    (B, feature_dim), all from the numpy
    `seed`. Returns numpy float64: (base inputs without the nn_measurement_*
    and the learned weight, obj_gt (T, 4), eff_gt (T, 4), features
    {step: (B, feature_dim)})."""
    from ...embodied.collision import occupancy_to_sdf

    rng = np.random.default_rng(seed)
    t = estimator.time_steps
    xs = np.linspace(0.1, 0.2, t)
    obj_gt = np.stack([xs, np.full_like(xs, 0.16), np.ones_like(xs), np.zeros_like(xs)], axis=-1)
    eff_gt = obj_gt.copy()
    eff_gt[:, 0] -= 0.03
    occ = np.zeros((32, 32))
    occ[12:20, 12:20] = 1.0

    def perturb(pose, scale, ang):  # (4,) -> (B, 4)
        theta = np.arctan2(pose[3], pose[2]) + rng.normal(scale=ang, size=batch)
        xy = pose[:2] + rng.normal(scale=scale, size=(batch, 2))
        return np.concatenate([xy, np.cos(theta)[:, None], np.sin(theta)[:, None]], axis=-1)

    inputs = {"obj_start_pose": obj_gt[:1].copy(), "sdf_data": occupancy_to_sdf(occ, 0.01)[None]}
    for i in range(t):
        mocap = perturb(eff_gt[i], mocap_noise, 0.0)
        inputs[f"motion_capture_{i}"] = mocap
        inputs[f"eff_pose_{i}"] = perturb(eff_gt[i], init_noise, angle_noise)
    obj0 = perturb(obj_gt[0], init_noise, angle_noise)
    for i in range(t):
        inputs[f"obj_pose_{i}"] = obj0
    features = {i: rng.standard_normal((batch, feature_dim)) for i in range(t)}
    return inputs, obj_gt, eff_gt, features


def relative_measurements(estimator: TactilePoseEstimator, obj_gt, eff_gt):
    """The ground-truth moving-frame measurements {nn_measurement_a_b: (1, 4)}
    (numpy float64): (obj_a^-1 eff_a)^-1 (obj_b^-1 eff_b)."""
    from ...lie import se2

    o, e = torch.as_tensor(obj_gt), torch.as_tensor(eff_gt)
    frame = se2.compose(se2.inverse(o), e)  # (T, 4)
    out = {}
    for (a, b) in estimator.pairs:
        out[f"nn_measurement_{a}_{b}"] = se2.compose(se2.inverse(frame[a]), frame[b]).numpy()[None]
    return out


# ---------------------------------------------------------------------------
# learnable models
# ---------------------------------------------------------------------------
class TactileMeasurementModel(nn.Module):
    """Image-feature pairs (B, f) x 2 -> an SE2 relative measurement (B, 4):
    the MLP [2f, hidden, hidden, 4]'s xy and its normalised (cos, sin)."""

    def __init__(self, feature_dim: int, generator: Optional[torch.Generator] = None, hidden: int = 64,
                 mlp: Optional[MLP] = None, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.mlp = mlp if mlp is not None else build_mlp([2 * feature_dim, hidden, hidden, 4], generator,
                                                         dtype=dtype, device=device)

    def forward(self, feat_a, feat_b):
        out = self.mlp(torch.cat([feat_a, feat_b], dim=-1))
        xy, cs = out[..., :2], out[..., 2:]
        return torch.cat([xy, cs / torch.linalg.vector_norm(cs, dim=-1, keepdim=True)], dim=-1)


class TactileWeightModel(nn.Module):
    """A scalar input (1, 1) -> a 3-dim diagonal weight (1, 3): softplus of
    the MLP [1, hidden, 3] (log(1 + e^x) without torch's linear cut-over,
    as jax.nn.softplus)."""

    def __init__(self, generator: Optional[torch.Generator] = None, hidden: int = 64, mlp: Optional[MLP] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.mlp = mlp if mlp is not None else build_mlp([1, hidden, 3], generator, dtype=dtype, device=device)

    def forward(self, k):
        x = self.mlp(k)
        return torch.logaddexp(x, torch.zeros_like(x))


def create_tactile_models(feature_dim: int, generator: torch.Generator, hidden: int = 64,
                          dtype: torch.dtype = torch.float32, device=None):
    """(measurement model, weight model), their weights drawn from
    `generator` (He-normal, zero biases, as `build_mlp`)."""
    return (TactileMeasurementModel(feature_dim, generator, hidden, dtype=dtype, device=device),
            TactileWeightModel(generator, hidden, dtype=dtype, device=device))


class TactileTrainer:
    """The outer loop: learns the measurement and weight models by
    differentiating the pose-estimation solve (`backward_mode`), with plain
    SGD at `lr`. `models` (measurement, weight) replace the drawn ones
    (`utils.convert.tactile_models_from_params`)."""

    def __init__(self, estimator: TactilePoseEstimator, feature_dim: int, generator: Optional[torch.Generator] = None,
                 lr: float = 1e-3, backward_mode: str = "implicit", models=None, dtype: Optional[torch.dtype] = None,
                 device=None):
        self.estimator = estimator
        co = estimator.objective.compile()
        dtype = dtype or co.dtype
        device = device if device is not None else co.device
        if models is None:
            if generator is None:
                generator = torch.Generator()
                generator.manual_seed(0)
            models = create_tactile_models(feature_dim, generator, dtype=dtype, device=device)
        self.meas_model, self.weight_model = models
        self.lr = lr
        self.backward_mode = backward_mode

    def parameters(self):
        return list(self.meas_model.parameters()) + list(self.weight_model.parameters())

    def build_inputs(self, base_inputs: Dict, features: Dict):
        """base_inputs with nn_measurement_* and mf_between_weight from the
        models; features {step: (B, f)}."""
        inputs = dict(base_inputs)
        for (a, b) in self.estimator.pairs:
            inputs[f"nn_measurement_{a}_{b}"] = self.meas_model(features[a], features[b])
        some = next(iter(self.weight_model.parameters()))
        inputs["mf_between_weight"] = self.weight_model(torch.ones((1, 1), dtype=some.dtype, device=some.device))
        return inputs

    def solve(self, base_inputs: Dict, features: Dict, backward_num_iterations: int = 5):
        """The solution {name: (B, ...)} of the objective under the models'
        inputs, differentiable by `backward_mode`."""
        est = self.estimator
        co = est.objective.compile()
        values = est.objective.default_values(self.build_inputs(base_inputs, features))
        bsz = co.resolve_batch_size(values)
        state = co.pack(values, bsz)
        aux = co.build_aux(values, bsz)
        carry = est.layer.solve_state(state, aux, self.backward_mode, est.optimizer.opts, backward_num_iterations)
        return co.unpack(carry["state"])

    def loss(self, base_inputs: Dict, features: Dict, obj_gt, backward_num_iterations: int = 5):
        """Mean squared xy error of every object pose against obj_gt (T, 4)."""
        sol = self.solve(base_inputs, features, backward_num_iterations)
        est = torch.stack([sol[f"obj_pose_{i}"] for i in range(self.estimator.time_steps)], dim=1)
        return torch.mean((est[..., :2] - obj_gt[None, :, :2]) ** 2)

    def step(self, base_inputs: Dict, features: Dict, obj_gt) -> float:
        params = self.parameters()
        for p in params:
            p.grad = None
        loss = self.loss(base_inputs, features, obj_gt)
        loss.backward()
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p -= self.lr * p.grad
        return float(loss.detach())
