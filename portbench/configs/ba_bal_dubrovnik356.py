"""Bundle adjustment at BAL Dubrovnik problem-356-226730-pre's counts with
BAL's 9-parameter cameras: its generator, the program's build and calls,
and the comparison with the plain reference (reference/ba.py).

On the device, from the configuration's own track seed (as a BAL file
fixes its tracks, so every run has the same visibility graph and the same
padded Schur sum): each point's track length (2 + a geometric draw,
adjusted to the configuration's observation count) and each track's
distinct cameras, by the program's BAL generator (`track_lengths`,
`bal_tracks` in utils/examples/bundle_adjustment.py). From the run's seed:
the scene (its `ring_poses` looking at a cube of points), each camera's
true f, k1, k2, the observed features (true projections plus pixel
noise), and a pool of initial-value draws (poses, points and intrinsics
each perturbed). The program and the
reference get the same float32 values. One reconstruction a call: batch 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import ba, lie, lm, precision

INTRINSICS = ("f", "k1", "k2")


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64, device=device)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float64, device=device)


class Problem:
    """One run's data and the program built on it.

    cfg: the configuration file; traffic: the traffic file; the program is
    built in cfg["dtype"] on `device`."""

    BATCH_AXIS = 1  # of each family's value (N, B, ...) the program takes

    def __init__(self, cfg, traffic, seed: int, device, train: bool = False):
        if train:
            raise ValueError("ba_bal_dubrovnik356 has no training traffic")
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        if cfg["camera_params"] != 9 or cfg["residual_dim"] != 2:
            raise ValueError("the generator makes BAL's 9-parameter cameras and 2-value residuals")
        if cfg["tracks"]["kind"] != "geometric" or cfg["scene"]["kind"] != "ring":
            raise ValueError(f"no generator for tracks {cfg['tracks']['kind']!r}, scene {cfg['scene']['kind']!r}")
        from theseus_tpu_torch.utils.examples.bundle_adjustment import bal_tracks, ring_poses, track_lengths

        C, P, O, b = cfg["n_cameras"], cfg["n_points"], cfg["n_observations"], traffic["batch"]
        self.C, self.P = C, P
        dev = self.device
        tgen = torch.Generator(device=dev)
        tgen.manual_seed(int(cfg["tracks"]["seed"]))
        k = track_lengths(tgen, C, P, O, cfg["tracks"]["extra_mean"], dev)
        self.obs_cam, self.obs_pt = bal_tracks(tgen, C, k, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if len(self.obs_cam) != O or int(k.min()) < cfg["tracks"]["min"]:
            raise ValueError(f"the tracks give {len(self.obs_cam)} observations, the configuration states {O}")
        sc, iv = cfg["scene"], cfg["initial_values"]
        gt_pose = ring_poses(C, sc["ring_radius"], sc["ring_height"], dev)[:, None].expand(C, b, 3, 4)
        h = sc["cube_half_width"]
        gt_pt = _uniform(gen, (P, b, 3), -h, h, dev)
        gt_intr = torch.stack([_uniform(gen, (C, b), *iv[n], dev) for n in INTRINSICS], -1)
        proj = ba.project(gt_pose[self.obs_cam], gt_pt[self.obs_pt], gt_intr[self.obs_cam])
        feat = proj + iv["pixel_noise"] * _normal(gen, proj.shape, dev)
        pool = []
        for _ in range(traffic["pool"]):
            pose = lie.compose(gt_pose, lie.exp(iv["pose_noise"] * _normal(gen, (C, b, 6), dev)))
            pt = gt_pt + iv["point_noise"] * _normal(gen, gt_pt.shape, dev)
            n = _normal(gen, (C, b, 3), dev)
            intr = torch.stack([gt_intr[..., 0] * (1.0 + iv["f_rel_noise"] * n[..., 0]),
                                gt_intr[..., 1] + iv["k1_noise"] * n[..., 1],
                                gt_intr[..., 2] + iv["k2_noise"] * n[..., 2]], -1)
            pool.append(tuple(t.to(self.dtype) for t in (pose, pt, intr)))
        # the inputs both sides get: the configuration's dtype
        self.pool = pool
        self.feat = feat.to(self.dtype)
        self.target = gt_pose[0].to(self.dtype)
        self._build_program()

    # -- the program ----------------------------------------------------
    def _ba_problem(self, i):
        from theseus_tpu_torch.utils.examples.bundle_adjustment import BAProblem

        pose, pt, intr = self.pool[i % len(self.pool)]
        return BAProblem(poses=pose, points=pt, focals=intr[..., 0:1], k1=intr[..., 1:2], k2=intr[..., 2:3],
                         obs_cam=self.obs_cam.cpu().numpy(), obs_pt=self.obs_pt.cpu().numpy(), obs_img=self.feat)

    def _build_program(self):
        import theseus_tpu_torch as tt
        from theseus_tpu_torch.utils.examples.bundle_adjustment import build_ba_objective, eliminate_landmarks

        # the program runs in the precision the configuration states
        tf32 = bool(self.cfg["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        solver = self.cfg["solver"]
        obj, _, pts, _ = build_ba_objective(self._ba_problem(0), dtype=self.dtype, device=self.device,
                                            gauge_target=self.target, optimize_intrinsics=True)
        self.opt = tt.LevenbergMarquardt(
            obj, max_iterations=solver["max_iterations"], linearization=solver["linearization"],
            adaptive_damping=solver["adaptive_damping"], ellipsoidal_damping=solver["ellipsoidal"],
            damping=solver["damping"], eliminate=eliminate_landmarks(pts))
        self.layer = tt.TheseusLayer(self.opt)

    def inputs(self, i):
        """The program's inputs of call i: pool draw i's initial values."""
        pose, pt, intr = self.pool[i % len(self.pool)]
        return {"cam": pose, "pt": pt, "intr": intr}

    def solve(self, i):
        """One timed call: a forward solve of pool draw i. Returns the
        output values and the solver's info."""
        with torch.no_grad():
            return self.layer.forward(self.inputs(i))

    def answer(self, out):
        """The kept answer of a call: (poses, points, intrinsics)."""
        return tuple(out[k].detach().clone() for k in ("cam", "pt", "intr"))

    def free_program(self):
        for name in ("layer", "opt"):
            self.__dict__.pop(name, None)

    # -- what the per-layer metrics count -----------------------------------
    def shapes(self):
        """The cell's sizes; the Schur pair sum's useful and padded camera
        pairs as the program's builder counts them (`pair_counts`), where
        the program has them."""
        out = {"batch": self.traffic["batch"], "n_obs": len(self.obs_cam), "n_cams": self.C, "n_pts": self.P,
               "dc": ba.DC, "dp": ba.DP, "iterations": self.cfg["solver"]["max_iterations"]}
        counts = getattr(getattr(getattr(self, "opt", None), "normal_builder", None), "pair_counts", None)
        if counts is not None:
            out["pairs_useful"], out["pairs_padded"] = counts()
        return out

    # -- the reference ------------------------------------------------------
    def _reference(self, dtype, store=None):
        return ba.BAL(self.C, self.P, self.obs_cam, self.obs_pt, self.feat.to(dtype), self.target.to(dtype),
                      self.cfg["prior_weight"], store)

    def reference_solve(self, i, prec="float64"):
        """The reference's solve of call i's inputs in precision `prec`
        (reference/precision.py): (poses, points, intrinsics)."""
        dtype, store = precision.dtypes(prec)
        opts = lm.options(self.cfg["solver"])
        with precision.products(prec):
            x, _ = ba.solve(self._reference(dtype, store), tuple(t.to(dtype) for t in self.pool[i % len(self.pool)]),
                            self.cfg["solver"]["max_iterations"], opts)
        return x

    def judge_solve(self, samples, prec="float64", detail=False):
        """samples: [(call index, (poses, points, intrinsics))]. Returns the
        largest over the samples of:
        - cost_gap: the mean over the batch of |f(x) - f(ref)| / f(ref), f
          the objective in float64;
        - intrinsics_gap: for each of f, k1, k2, |theta - theta_ref| /
          |theta_ref - theta_0| over all cameras and the batch (theta_0 the
          call's initial values), the largest of the three: a program that
          never moves the intrinsics reads 1.
        A value that is not a number reads infinite. With `detail`, also the
        signed mean and the largest element of the cost gaps, and each
        intrinsic's gap."""
        f64 = self._reference(torch.float64)
        out = {"cost_gap": 0.0, "intrinsics_gap": 0.0}
        signed, largest, each = [], [], {n: 0.0 for n in INTRINSICS}
        for i, x in samples:
            ref = self.reference_solve(i, prec)
            f_ref = f64.cost(tuple(t.to(torch.float64) for t in ref))
            gap = (f64.cost(tuple(t.to(torch.float64) for t in x)) - f_ref) / f_ref
            gap = torch.nan_to_num(gap, nan=float("inf"))
            out["cost_gap"] = max(out["cost_gap"], float(gap.abs().mean()))
            signed.append(float(gap.mean()))
            largest.append(float(gap.max()))
            th0 = self.pool[i % len(self.pool)][2].to(torch.float64)
            th, th_ref = x[2].to(torch.float64), ref[2].to(torch.float64)
            for j, n in enumerate(INTRINSICS):
                g = float(torch.linalg.norm(th[..., j] - th_ref[..., j]) / torch.linalg.norm(th_ref[..., j] - th0[..., j]))
                each[n] = max(each[n], g if math.isfinite(g) else float("inf"))
            out["intrinsics_gap"] = max(out["intrinsics_gap"], max(each.values()))
        if detail:
            out.update(cost_gap_signed=float(np.mean(signed)), cost_gap_max=max(largest),
                       **{f"intrinsics_gap_{n}": v for n, v in each.items()})
        return out


def freeze_intrinsics(prob):
    """A fault: the program solves with the intrinsics held at each call's
    initial values (aux, not variables), so only poses and points move."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective

    solver = prob.cfg["solver"]

    def solve(i):
        bp = prob._ba_problem(i)
        obj, _, _ = build_ba_objective(bp, dtype=prob.dtype, device=prob.device, gauge_target=prob.target)
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(
            obj, max_iterations=solver["max_iterations"], linearization=solver["linearization"],
            adaptive_damping=solver["adaptive_damping"], ellipsoidal_damping=solver["ellipsoidal"],
            damping=solver["damping"]))
        with torch.no_grad():
            out, info = layer.forward(ba_values(bp))
        return dict(out, intr=prob.inputs(i)["intr"]), info

    prob.solve = solve
