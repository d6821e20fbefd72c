"""Plain reference of bundle adjustment with BAL's 9-parameter cameras.

The problem of "Bundle Adjustment in the Large" (Agarwal, Snavely, Seitz,
Szeliski, ECCV 2010): camera c has a pose (R, t), world to camera, and
intrinsics (f, k1, k2); observation o of point X by camera c has the
residual

    P = R X + t,  p = -P_xy / P_z,  e = f (1 + k1 |p|^2 + k2 |p|^4) p - feat

(2 values), all 9 camera parameters and the 3 of each point optimised.
f = |e|^2 / 2 summed over the observations, plus a Local prior on camera
0's pose, w log(target^-1 x_0), that fixes six of the gauge's seven degrees.
Departures from BAL: a pose is updated by the SE3 retraction x exp(d), d =
(translation, rotation), where BAL adds to its angle-axis vector; and the
prior, which BAL has not (its solvers leave the gauge to the damping, as
the scale is left here).

Jacobians by forward-mode autodiff (torch.func.jvp) of the residual along
the pose's tangent x (I + d^) (reference/lie.py `perturb`), the point and
the intrinsics. The damped normal equations are solved by eliminating the
points: each point's 3 x 3 block inverted, W = Hcp Hpp^-1 per observation,
the reduced camera matrix S (C * 9 square) summed by a plain scatter over
the camera pairs of each point's track, in blocks of pairs, then one dense
Cholesky; LM from reference/lm.py. Nothing here imports the program under
test; a caller that wants full float32 products turns TF32 off
(reference/precision.py `products`).
"""

from __future__ import annotations

import torch

from . import lie

DC, DP = 9, 3  # a camera's dofs (pose 6, intrinsics 3) and a point's
PAIR_BLOCK = 1 << 20  # camera pairs a block of the scatter into S


def project(pose, point, intr):
    """BAL's projection: pose (..., 3, 4), point (..., 3), intr (..., 3)
    -> the predicted feature (..., 2)."""
    p_cam = (pose[..., :3] @ point[..., None])[..., 0] + pose[..., 3]
    p = -p_cam[..., :2] / p_cam[..., 2:3]
    r2 = torch.sum(p * p, dim=-1, keepdim=True)
    f, k1, k2 = intr[..., 0:1], intr[..., 1:2], intr[..., 2:3]
    return f * (1.0 + k1 * r2 + k2 * r2 * r2) * p


class BAL:
    """C cameras, P points; obs_cam, obs_pt (O,) long tensors; feat
    (O, B, 2) observed features; target (B, 3, 4) the prior's pose; prior_w
    a number. store: None, or a dtype in which the features, the state
    after each step and the linearization's residuals and jacobians are
    stored (rounded), the arithmetic staying in the features' dtype. A
    state is (poses (C, B, 3, 4), points (P, B, 3), intrinsics (C, B, 3))."""

    def __init__(self, n_cams, n_pts, obs_cam, obs_pt, feat, target, prior_w, store=None):
        self.C, self.P = int(n_cams), int(n_pts)
        self.store = store
        self.cam, self.pt = obs_cam, obs_pt
        self.feat, self.target, self.prior_w = self.stored(feat), target, float(prior_w)
        # every camera pair (a, b) of each point's track, as observation
        # indices: the pairs S sums over
        order = torch.argsort(obs_pt, stable=True)
        k = torch.bincount(obs_pt, minlength=self.P)
        start = torch.cumsum(k, 0) - k
        kk = k[obs_pt[order]]
        a = torch.repeat_interleave(order, kk)
        first = torch.repeat_interleave(start[obs_pt[order]], kk)
        pos = torch.arange(len(a), device=a.device) - torch.repeat_interleave(torch.cumsum(kk, 0) - kk, kk)
        self.pair_a, self.pair_b = a, order[first + pos]

    def stored(self, t):
        return t if self.store is None else t.to(self.store).to(t.dtype)

    # -- residuals ---------------------------------------------------------
    def _obs_res(self, pose, point, intr):
        return project(pose, point, intr) - self.feat

    def _prior_res(self, x0):
        return self.prior_w * lie.local(self.target, x0)

    def cost(self, x):
        poses, points, intr = x
        e = self._obs_res(poses[self.cam], points[self.pt], intr[self.cam])
        p = self._prior_res(poses[0])
        return 0.5 * (torch.sum(e * e, dim=(0, 2)) + torch.sum(p * p, dim=-1))

    def linearize(self, x):
        """(jc (O, B, 2, 9): pose then intrinsics, jp (O, B, 2, 3), e
        (O, B, 2), jprior (B, 6, 6), eprior (B, 6))."""
        poses, points, intr = x
        pose, point, ic = poses[self.cam], points[self.pt], intr[self.cam]
        z6 = torch.zeros(pose.shape[:-2] + (6,), dtype=pose.dtype, device=pose.device)
        z3 = torch.zeros_like(point)
        cols_c, cols_p, cols_0 = [], [], []
        e = ep = None
        for k in range(6):
            d = torch.zeros_like(z6)
            d[..., k] = 1.0
            e, t = torch.func.jvp(lambda u: self._obs_res(lie.perturb(pose, u), point, ic), (z6,), (d,))
            cols_c.append(t)
            ep, t0 = torch.func.jvp(lambda u: self._prior_res(lie.perturb(poses[0], u)), (z6[0],), (d[0],))
            cols_0.append(t0)
        for k in range(3):
            d = torch.zeros_like(z3)
            d[..., k] = 1.0
            _, t = torch.func.jvp(lambda u: self._obs_res(pose, point + u, ic), (z3,), (d,))
            cols_p.append(t)
            _, t = torch.func.jvp(lambda u: self._obs_res(pose, point, ic + u), (z3,), (d,))
            cols_c.append(t)
        out = torch.stack(cols_c, -1), torch.stack(cols_p, -1), e, torch.stack(cols_0, -1), ep
        return tuple(self.stored(t) for t in out)

    # -- normal equations ----------------------------------------------------
    def normal(self, x):
        """g = -J^T e (B, D) and diag(H) (B, D), cameras (9 each) first, then
        points (3 each); the system (Hcc (C, B, 9, 9), Hpp (P, B, 3, 3), Hcp
        (O, B, 9, 3), gc (C, B, 9), gp (P, B, 3))."""
        jc, jp, e, j0, e0 = self.linearize(x)
        b, dt, dev = e.shape[1], e.dtype, e.device
        hcc = torch.zeros((self.C, b, DC, DC), dtype=dt, device=dev)
        hcc.index_add_(0, self.cam, jc.transpose(-1, -2) @ jc)
        hcc[0, :, :6, :6] += j0.transpose(-1, -2) @ j0
        hpp = torch.zeros((self.P, b, DP, DP), dtype=dt, device=dev).index_add_(0, self.pt, jp.transpose(-1, -2) @ jp)
        hcp = jc.transpose(-1, -2) @ jp
        gc = torch.zeros((self.C, b, DC), dtype=dt, device=dev)
        gc.index_add_(0, self.cam, -(jc.transpose(-1, -2) @ e[..., None])[..., 0])
        gc[0, :, :6] -= (j0.transpose(-1, -2) @ e0[..., None])[..., 0]
        gp = torch.zeros((self.P, b, DP), dtype=dt, device=dev)
        gp.index_add_(0, self.pt, -(jp.transpose(-1, -2) @ e[..., None])[..., 0])
        g = torch.cat([gc.movedim(1, 0).reshape(b, -1), gp.movedim(1, 0).reshape(b, -1)], dim=1)
        diag = torch.cat([torch.diagonal(hcc, dim1=-2, dim2=-1).movedim(1, 0).reshape(b, -1),
                          torch.diagonal(hpp, dim1=-2, dim2=-1).movedim(1, 0).reshape(b, -1)], dim=1)
        return g, diag, (hcc, hpp, hcp, gc, gp)

    def solve(self, system, damping, opts):
        """(H + damping) d = g with the points eliminated; a batch element
        whose factor fails gets bad = True and a zero step."""
        from .lm import damp

        hcc, hpp, hcp, gc, gp = system
        C, P, b = self.C, self.P, gc.shape[1]

        def damped(h):
            dg = torch.diagonal(h, dim1=-2, dim2=-1)  # (N, B, d)
            nd = damp(dg.movedim(1, 0).reshape(b, -1), damping, opts).reshape(b, h.shape[0], -1).movedim(0, 1)
            return h - torch.diag_embed(dg) + torch.diag_embed(nd)

        hcc, hpp = damped(hcc), damped(hpp)
        hpp_inv = torch.linalg.inv(0.5 * (hpp + hpp.transpose(-1, -2)))
        w = hcp @ hpp_inv[self.pt]  # (O, B, 9, 3)
        s = torch.zeros((C * C, b, DC, DC), dtype=hcc.dtype, device=hcc.device)
        s[torch.arange(C, device=s.device) * (C + 1)] = hcc
        for lo in range(0, len(self.pair_a), PAIR_BLOCK):
            a, c = self.pair_a[lo:lo + PAIR_BLOCK], self.pair_b[lo:lo + PAIR_BLOCK]
            s.index_add_(0, self.cam[a] * C + self.cam[c], -(w[a] @ hcp[c].transpose(-1, -2)))
        s = s.reshape(C, C, b, DC, DC).permute(2, 0, 3, 1, 4).reshape(b, C * DC, C * DC)
        rc = gc.clone().index_add_(0, self.cam, -(w @ gp[self.pt][..., None])[..., 0])
        l, info = torch.linalg.cholesky_ex(0.5 * (s + s.transpose(-1, -2)))
        xc = torch.cholesky_solve(rc.movedim(1, 0).reshape(b, -1, 1), l)[..., 0]  # (B, C * 9)
        xcb = xc.reshape(b, C, DC).movedim(1, 0)
        rp = gp.clone().index_add_(0, self.pt, -(hcp.transpose(-1, -2) @ xcb[self.cam][..., None])[..., 0])
        xp = (hpp_inv @ rp[..., None])[..., 0]
        d = torch.cat([xc, xp.movedim(1, 0).reshape(b, -1)], dim=1)
        bad = (info != 0) | ~torch.all(torch.isfinite(d), dim=-1)
        return torch.where(bad[:, None], torch.zeros_like(d), d), bad

    def retract(self, x, d):
        poses, points, intr = x
        b, C = d.shape[0], self.C
        dc = d[:, : C * DC].reshape(b, C, DC).movedim(1, 0)
        dp = d[:, C * DC:].reshape(b, self.P, DP).movedim(1, 0)
        out = (lie.compose(poses, lie.exp(dc[..., :6])), points + dp, intr + dc[..., 6:])
        return tuple(self.stored(t) for t in out)

    @staticmethod
    def select(mask, a, b):
        return tuple(torch.where(mask.reshape((1, -1) + (1,) * (x.dim() - 2)), x, y) for x, y in zip(a, b))


def solve(problem: BAL, x0, iterations: int, opts: dict):
    """LM from x0 = (poses, points, intrinsics); returns (x, cost (B,))."""
    from . import lm

    return lm.solve(problem, tuple(problem.stored(t) for t in x0), iterations, opts)
