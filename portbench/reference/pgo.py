"""Plain reference of the SE3 pose-graph solve and of its implicit gradient.

Costs: a Between per edge (i, j), residual w log(m^-1 x_i^-1 x_j), and a
Local prior on pose 0, residual w0 log(target^-1 x_0). Jacobians by
forward-mode autodiff of those residuals along x (I + d^). The normal
equations are kept block tridiagonal: poses are grouped, in index order,
into super-blocks of `span` poses, the fewest with which only neighbouring
super-blocks couple; they are factored by
the block-tridiagonal Cholesky recurrence, batched over the batch. Nothing
here imports the program under test.
"""

from __future__ import annotations

import torch

from . import lie, lm


class PoseGraph:
    """n poses, edges (E, 2) long, measurements (E, B, 3, 4), prior target
    (B, 3, 4). edge_w: (E,) weight of each Between (a tensor, so that a
    learned weight can carry a tangent); prior_w a number. store: None, or
    a dtype in which the measurements, the poses after each step and the
    linearization's residuals and jacobians are stored (rounded), the
    arithmetic staying in the measurements' dtype."""

    def __init__(self, n, edges, meas, target, edge_w, prior_w, store=None):
        self.n = n
        self.i, self.j = edges[:, 0], edges[:, 1]
        self.store = store
        self.meas, self.target = self.stored(meas), target
        self.edge_w, self.prior_w = edge_w, float(prior_w)
        lo, hi = torch.minimum(self.i, self.j), torch.maximum(self.i, self.j)
        # the smallest super-block that keeps every edge within two
        # neighbouring ones (a span of max |i - j| always does)
        span = max(int(torch.max(hi - lo)), 1)
        self.span = next(s for s in range(-(-span // 2), span + 1) if not bool(torch.any(hi // s - lo // s > 1)))
        self.nb = -(-n // self.span)
        self.lo, self.hi = lo, hi

    def stored(self, t):
        return t if self.store is None else t.to(self.store).to(t.dtype)

    # -- residuals -----------------------------------------------------
    def _edge_res(self, xi, xj):
        return self.edge_w[:, None, None] * lie.log(lie.compose(lie.inverse(self.meas), lie.compose(lie.inverse(xi), xj)))

    def _prior_res(self, x0):
        return self.prior_w * lie.local(self.target, x0)

    def cost(self, x):
        e = self._edge_res(x[self.i], x[self.j])
        p = self._prior_res(x[0])
        return 0.5 * (torch.sum(e * e, dim=(0, 2)) + torch.sum(p * p, dim=-1))

    def linearize(self, x):
        """(ji, jj (E, B, 6, 6), e (E, B, 6), jp (B, 6, 6), ep (B, 6))."""
        xi, xj, x0 = x[self.i], x[self.j], x[0]
        zi = torch.zeros(xi.shape[:-2] + (6,), dtype=x.dtype, device=x.device)
        ji, jj, jp = [], [], []
        e = ep = None
        for k in range(6):
            basis = torch.zeros_like(zi)
            basis[..., k] = 1.0
            e, ti = torch.func.jvp(lambda d: self._edge_res(lie.perturb(xi, d), xj), (zi,), (basis,))
            _, tj = torch.func.jvp(lambda d: self._edge_res(xi, lie.perturb(xj, d)), (zi,), (basis,))
            ep, tp = torch.func.jvp(lambda d: self._prior_res(lie.perturb(x0, d)), (zi[0],), (basis[0],))
            ji.append(ti)
            jj.append(tj)
            jp.append(tp)
        out = torch.stack(ji, -1), torch.stack(jj, -1), e, torch.stack(jp, -1), ep
        return tuple(self.stored(t) for t in out)

    # -- block-tridiagonal normal equations -----------------------------
    def normal(self, x):
        """g = -J^T e (B, 6n), diag(H) (B, 6n), and H as diagonal super-blocks
        (nb, B, 6s, 6s) and sub-diagonal ones (nb - 1, B, 6s, 6s)."""
        ji, jj, e, jp, ep = self.linearize(x)
        return self.assemble(ji, jj, e, jp, ep)

    def assemble(self, ji, jj, e, jp, ep):
        s, nb, b = self.span, self.nb, e.shape[1]
        dt, dev = e.dtype, e.device
        hd = torch.zeros((nb, s, s, b, 6, 6), dtype=dt, device=dev)
        ho = torch.zeros((max(nb - 1, 1), s, s, b, 6, 6), dtype=dt, device=dev)
        g = torch.zeros((nb * s, b, 6), dtype=dt, device=dev)
        # the lower pose of each edge is `lo`; the coupling block is (hi, lo)
        swap = self.i > self.j
        jl = torch.where(swap[:, None, None, None], jj, ji)
        jh = torch.where(swap[:, None, None, None], ji, jj)
        lo, hi = self.lo, self.hi
        blk = lambda a, c: torch.einsum("ebki,ebkj->ebij", a, c)  # noqa: E731
        for idx, h in ((lo, blk(jl, jl)), (hi, blk(jh, jh))):
            hd.index_put_((idx // s, idx % s, idx % s), h, accumulate=True)
        cross = blk(jh, jl)  # rows hi, columns lo
        same = hi // s == lo // s
        sl, hs = lo[same], hi[same]
        hd.index_put_((sl // s, hs % s, sl % s), cross[same], accumulate=True)
        hd.index_put_((sl // s, sl % s, hs % s), cross[same].transpose(-1, -2), accumulate=True)
        nxt = ~same
        ho.index_put_((lo[nxt] // s, hi[nxt] % s, lo[nxt] % s), cross[nxt], accumulate=True)
        hd[0, 0, 0] += torch.einsum("bki,bkj->bij", jp, jp)
        g.index_add_(0, lo, -torch.einsum("ebki,ebk->ebi", jl, e))
        g.index_add_(0, hi, -torch.einsum("ebki,ebk->ebi", jh, e))
        g[0] -= torch.einsum("bki,bk->bi", jp, ep)
        # padding poses past n carry an identity diagonal
        pad = torch.arange(self.n, nb * s, device=dev)
        if len(pad):
            hd[pad // s, pad % s, pad % s] += torch.eye(6, dtype=dt, device=dev)
        hd = hd.permute(0, 3, 1, 4, 2, 5).reshape(nb, b, 6 * s, 6 * s)
        ho = ho.permute(0, 3, 1, 4, 2, 5).reshape(-1, b, 6 * s, 6 * s)
        g = g.movedim(1, 0).reshape(b, -1)
        diag = torch.diagonal(hd, dim1=-2, dim2=-1).movedim(0, 1).reshape(b, -1)
        return g[:, : 6 * self.n], diag[:, : 6 * self.n], (hd, ho, g)

    def solve(self, system, damping, opts):
        """(H + damping) d = g by the block-tridiagonal Cholesky; a batch
        element whose factor fails gets bad = True and a zero step."""
        hd, ho, g = system
        nb, b, m = hd.shape[0], hd.shape[1], hd.shape[2]
        n6 = 6 * self.n
        diag = torch.diagonal(hd, dim1=-2, dim2=-1)
        real = (torch.arange(nb * m, device=hd.device) < n6).reshape(nb, 1, m)
        damped = torch.where(real, lm.damp(diag.movedim(1, 0).reshape(b, -1), damping, opts)
                             .reshape(b, nb, m).movedim(0, 1), diag)
        hd = hd - torch.diag_embed(diag) + torch.diag_embed(damped)
        ls, cs = [], []
        bad = torch.zeros((b,), dtype=torch.bool, device=hd.device)
        for k in range(nb):
            dk = hd[k]
            if k:
                c = torch.linalg.solve_triangular(ls[-1], ho[k - 1].transpose(-1, -2), upper=False).transpose(-1, -2)
                cs.append(c)
                dk = dk - c @ c.transpose(-1, -2)
            lk, info = torch.linalg.cholesky_ex(dk)
            bad = bad | (info != 0)
            ls.append(lk)
        rhs = g.reshape(b, nb, m)
        y = []
        for k in range(nb):
            r = rhs[:, k, :, None]
            if k:
                r = r - cs[k - 1] @ y[-1]
            y.append(torch.linalg.solve_triangular(ls[k], r, upper=False))
        xs = [None] * nb
        for k in reversed(range(nb)):
            r = y[k]
            if k + 1 < nb:
                r = r - cs[k].transpose(-1, -2) @ xs[k + 1]
            xs[k] = torch.linalg.solve_triangular(ls[k].transpose(-1, -2), r, upper=True)
        d = torch.cat(xs, dim=1)[:, :n6, 0]
        bad = bad | ~torch.all(torch.isfinite(d), dim=-1)
        return torch.where(bad[:, None], torch.zeros_like(d), d), bad

    def retract(self, x, d):
        return self.stored(lie.compose(x, lie.exp(d.reshape(d.shape[0], -1, 6).movedim(1, 0))))

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[None, :, None, None], a, b)


def solve(graph: PoseGraph, x0, iterations: int, opts: dict):
    """LM from x0 (N, B, 3, 4); returns (x, cost (B,))."""
    return lm.solve(graph, graph.stored(x0), iterations, opts)


def mean_sq_local(x, gt):
    """The training loss: the mean over poses and batch of |log(x^-1 gt)|^2."""
    d = lie.local(x, gt)
    return torch.mean(torch.sum(d * d, dim=-1))


def implicit_loss_and_grad(graph: PoseGraph, x_star, gt, loop_mask, theta: float):
    """The loss after one Gauss-Newton step from the solution x_star, and its
    derivative in the loop-closure weight theta, with H held fixed
    (the implicit-function gradient). loop_mask (E,) marks the Betweens
    weighted by theta (their residuals scale with theta, so g = g_odo +
    theta^2 g_loop). Returns (loss, d loss / d theta) as floats and the
    poses after the step."""
    ji, jj, e, jp, ep = graph.linearize(x_star)
    w = torch.where(loop_mask, 1.0 / theta, 1.0).to(e.dtype)[:, None, None]
    # residuals and jacobians of the loop closures without their weight
    ji0, jj0, e0 = ji * w[..., None], jj * w[..., None], e * w
    zeros = torch.zeros_like(jp)
    lm_ = loop_mask[:, None, None]
    _, _, (hd, ho, _) = graph.assemble(ji, jj, e, jp, ep)
    g_odo = graph.assemble(ji0, jj0, torch.where(lm_, 0.0, e0), jp, ep)[2][2]
    g_loop = graph.assemble(ji0, jj0, torch.where(lm_, e0, 0.0), zeros, torch.zeros_like(ep))[2][2]
    zero = torch.zeros((e.shape[1],), dtype=e.dtype, device=e.device)
    opts = dict(lm.DEFAULTS)
    d_odo, _ = graph.solve((hd, ho, g_odo), zero, opts)
    d_loop, _ = graph.solve((hd, ho, g_loop), zero, opts)
    t = torch.tensor(float(theta), dtype=e.dtype, device=e.device)

    def loss(th):
        return mean_sq_local(graph.retract(x_star, d_odo + th * th * d_loop), gt)

    val, dval = torch.func.jvp(loss, (t,), (torch.ones_like(t),))
    return float(val), float(dval), graph.retract(x_star, d_odo + t * t * d_loop)
