"""Gaussian belief propagation (GBP) over the factor graph (JAX counterpart: theseus_tpu/optim/gbp.py).

Synchronous (Jacobi-style) message passing: every factor-to-variable
message of a cost bucket is computed in one batched step per sweep, and the
variable beliefs are `index_add` scatters over static indices. GBP is one
more normal-system backend (`GBPNormal`), so the same object serves the
forward solve, the implicit backward's final detached-Hessian step and DLM.

Information form (Ortiz et al., "A visual introduction to Gaussian belief
propagation", 2021): a factor with stacked weighted jacobian
J = [J_1 .. J_k] and residual r carries Lam = J^T J, eta = -J^T r over its
variables' tangent coordinates. The message to slot s marginalizes the
factor plus the other slots' cavity beliefs (belief minus own message):

    M        = Lam_oo + diag(cavity_o)            (o = every slot but s)
    lam_msg  = Lam_ss - Lam_so M^{-1} Lam_os
    eta_msg  = eta_s  - Lam_so M^{-1} (eta_o + cavity_eta_o)

Beliefs are the sums of incoming messages plus a small prior ridge (and the
LM damping as a per-batch prior). With enough sweeps the belief means solve
the Gauss-Newton normal equations exactly on trees and approximately on
loopy graphs. `marginals()` gives each variable's posterior information.

The solves are `torch.linalg.solve_ex` with NaN where `info != 0`
(`torch.linalg.solve` checks `info` and syncs with the host on the card).
Each sweep dispatches every bucket and slot from Python (the JAX package
traces the sweep once inside `lax.scan`): expect it to be host-bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.compiled import CompiledObjective
from .gaussian import ManifoldGaussian
from .linear import finite_or_zero
from .nonlinear import NLSOptions, NonlinearLeastSquares
from .normal import BlockNormalBuilder


@dataclasses.dataclass(frozen=True)
class GBPOptions(NLSOptions):
    msg_iters: int = 30  # synchronous sweeps per linearization
    msg_damping: float = 0.3  # new_msg = (1 - a) computed + a old (loopy graphs)
    gbp_ridge: float = 1e-6  # per-variable prior precision (numeric anchor)


def _blk(lam_b, s: int, t: int):
    """Factor precision block Lam[s][t] from the upper-triangular storage
    lam_b[s][t - s] (s <= t); lower blocks are transposes."""
    if s <= t:
        return lam_b[s][t - s]
    return lam_b[t][s - t].transpose(-1, -2)


def _solve(a, b):
    """a^{-1} b, NaN for a batch element whose LU fails."""
    x, info = torch.linalg.solve_ex(a, b)
    return torch.where((info != 0)[..., None, None], torch.nan, x)


def _scatter_plan(g: np.ndarray, device):
    """`GBPNormalBuilder.scatter_plan` for the ids g (K,)."""
    order = np.argsort(g, kind="stable")
    first = np.searchsorted(g[order], g[order])  # start of each id's run in sorted order
    rank = np.empty(len(g), dtype=np.int64)
    rank[order] = np.arange(len(g)) - first
    if len(g) == 0 or rank.max() == 0:
        return [(None, torch.as_tensor(g, dtype=torch.long, device=device))]
    plan = []
    for r in range(int(rank.max()) + 1):
        rows = np.nonzero(rank == r)[0]
        plan.append((torch.as_tensor(rows, dtype=torch.long, device=device),
                     torch.as_tensor(g[rows], dtype=torch.long, device=device)))
    return plan


class GBPNormal:
    """Message-passing view of the normal equations J^T J dx = -J^T r."""

    def __init__(self, builder: "GBPNormalBuilder", lams, etas, dtype, bsz):
        self.builder = builder
        # per bucket: lams[bi][s][t - s] (K, B, d, d) for s <= t; etas[bi][s] (K, B, d)
        self.lams = lams
        self.etas = etas
        self.dtype = dtype
        self.device = etas[0][0].device
        self.bsz = bsz
        self._Atb = None

    def _zeros_v(self, *tail):
        return torch.zeros((self.builder.n, self.bsz) + tail, dtype=self.dtype, device=self.device)

    # -- the normal-system protocol ----------------------------------------
    @property
    def Atb(self):
        if self._Atb is None:
            self._Atb = self.builder.flatten(self._scatter(self._zeros_v(self.builder.d), self.etas))
        return self._Atb

    def diag(self):
        diags = [[torch.diagonal(_blk(lam_b, s, s), dim1=-2, dim2=-1) for s in range(len(lam_b))]
                 for lam_b in self.lams]
        return self.builder.flatten(self._scatter(self._zeros_v(self.builder.d), diags))

    def quad(self, v):
        bld = self.builder
        vb = bld.unflatten(v)  # (n, B, d)
        out = 0.0
        for bi, lam_b in enumerate(self.lams):
            k = len(lam_b)
            for s in range(k):
                vs = vb[bld.gv(bi, s, vb.device)]  # (K, B, d)
                for t in range(s, k):
                    vt = vb[bld.gv(bi, t, vb.device)]
                    term = torch.einsum("kbi,kbij,kbj->b", vs, _blk(lam_b, s, t), vt)
                    out = out + (term if s == t else 2.0 * term)
        return out

    # -- message passing ---------------------------------------------------
    def _scatter(self, base, items):
        """base + the sum of items[bi][s] (K, B, ...) added into bucket bi's
        slot-s variables. The sum starts from zeros and meets base last, and
        no index_add call adds to one variable twice (`scatter_plan`), so
        the order of the adds is fixed: the card's atomic adds cannot
        reorder them, and a factor-sharded sum (`ShardedGBPNormal`) groups
        a variable's terms as this one does wherever at most two meet."""
        acc = torch.zeros_like(base)
        for bi, per_slot in enumerate(items):
            for s, x in enumerate(per_slot):
                acc = self._add_slot(acc, bi, s, x)
        return base + acc

    def _add_slot(self, acc, bi: int, s: int, x):
        for rows, gv in self.builder.scatter_plan(bi, s, x.device):
            acc = acc.index_add(0, gv, x if rows is None else x[rows])
        return acc

    def _beliefs(self, msgs, prior_lam, prior_eta):
        eta_v = self._scatter(prior_eta, [[e for e, _ in bucket] for bucket in msgs])
        lam_v = self._scatter(prior_lam, [[l for _, l in bucket] for bucket in msgs])
        return lam_v, eta_v

    def _sweep(self, msgs, prior_lam, prior_eta, alpha: float):
        lam_v, eta_v = self._beliefs(msgs, prior_lam, prior_eta)
        return tuple(self._bucket_messages(bi, bucket, lam_v, eta_v, alpha) for bi, bucket in enumerate(msgs))

    def _bucket_messages(self, bi: int, bucket, lam_v, eta_v, alpha: float):
        """Bucket bi's new messages from the beliefs (lam_v, eta_v), which
        lie on the device of the bucket's factors."""
        bld = self.builder
        k = len(bucket)
        lam_b, eta_b = self.lams[bi], self.etas[bi]
        out_bucket = []
        for s in range(k):
            if k == 1:
                out_bucket.append((eta_b[0], _blk(lam_b, 0, 0)))
                continue
            others = [o for o in range(k) if o != s]
            # cavity of the other slots: belief minus own message
            cav = []
            for o in others:
                gv = bld.gv(bi, o, lam_v.device)
                cav.append((eta_v[gv] - bucket[o][0], lam_v[gv] - bucket[o][1]))
            # M = Lam_oo + diag(cavity); R = Lam_{o,s}; r = eta_o + cavity
            rows = [torch.cat([_blk(lam_b, o, o2) + cav[a][1] if o == o2 else _blk(lam_b, o, o2)
                               for o2 in others], dim=-1) for a, o in enumerate(others)]
            m = torch.cat(rows, dim=-2)  # (K, B, (k-1)d, (k-1)d)
            r_blk = torch.cat([_blk(lam_b, o, s) for o in others], dim=-2)  # (K, B, (k-1)d, d)
            r_vec = torch.cat([eta_b[o] + cav[a][0] for a, o in enumerate(others)], dim=-1)
            x = _solve(m, torch.cat([r_blk, r_vec[..., None]], dim=-1))
            rt = r_blk.transpose(-1, -2)
            lam_new = _blk(lam_b, s, s) - rt @ x[..., :-1]
            eta_new = eta_b[s] - (rt @ x[..., -1:])[..., 0]
            old_eta, old_lam = bucket[s]
            out_bucket.append(((1.0 - alpha) * eta_new + alpha * old_eta,
                               (1.0 - alpha) * lam_new + alpha * old_lam))
        return tuple(out_bucket)

    def _priors(self, damping, rhs_shift, ridge_val=None):
        bld = self.builder
        dev = self.device
        dof_mask, pad_eye = bld.consts(dev, self.dtype)
        eye = torch.eye(bld.d, dtype=self.dtype, device=dev)
        base_ridge = bld.opts_ridge if ridge_val is None else ridge_val
        if isinstance(damping, torch.Tensor):
            damp = damping.to(self.dtype).reshape(-1, 1, 1) * torch.ones((self.bsz, 1, 1), dtype=self.dtype,
                                                                          device=dev)
        else:  # a Python number: filled on the device, no host copy
            damp = torch.full((self.bsz, 1, 1), float(damping), dtype=self.dtype, device=dev)
        ridge = base_ridge + damp  # (B, 1, 1): the LM damping as a diagonal prior
        # true dims: ridge; padding dims: identity (keeps M invertible)
        prior_lam = dof_mask[:, None, :, None] * eye * ridge[None] + pad_eye[:, None]  # (n, B, d, d)
        prior_eta = torch.zeros((bld.n, self.bsz, bld.d), dtype=self.dtype, device=dev)
        if rhs_shift is not None:
            prior_eta = prior_eta - bld.unflatten(rhs_shift)
        return prior_lam, prior_eta

    def _run(self, damping, rhs_shift=None, msg_iters=None, msg_damping=None, ridge=None):
        """msg_iters, msg_damping and ridge override the builder's defaults
        for this call (`forward(optimizer_kwargs={"msg_iters": ...})`)."""
        bld = self.builder
        prior_lam, prior_eta = self._priors(damping, rhs_shift, ridge)
        msgs = tuple(
            tuple((torch.zeros_like(e), torch.zeros_like(_blk(lam_b, s, s))) for s, e in enumerate(eta_b))
            for eta_b, lam_b in zip(self.etas, self.lams)
        )
        alpha = bld.msg_damping if msg_damping is None else float(msg_damping)
        iters = bld.msg_iters if msg_iters is None else int(msg_iters)
        for _ in range(iters):
            msgs = self._sweep(msgs, prior_lam, prior_eta, alpha)
        return self._beliefs(msgs, prior_lam, prior_eta)

    def solve(self, damping=0.0, ellipsoidal=False, rhs_shift=None, msg_iters=None, msg_damping=None, ridge=None):
        """Returns (delta (B, D), fail (B,)). Ellipsoidal damping has no
        message-passing analog: the scalar damping enters as a prior."""
        lam_v, eta_v = self._run(damping, rhs_shift, msg_iters, msg_damping, ridge)
        dx = _solve(lam_v, eta_v[..., None])[..., 0]  # (n, B, d)
        dof_mask, _ = self.builder.consts(dx.device, dx.dtype)
        return finite_or_zero(self.builder.flatten(dx * dof_mask[:, None, :]))

    def marginals(self, damping=0.0):
        """Posterior tangent-space information per variable: (mean blocks
        (n, B, d), precision (n, B, d, d)); the caller strips the padding."""
        lam_v, eta_v = self._run(damping)
        return _solve(lam_v, eta_v[..., None])[..., 0], lam_v


class GBPNormalBuilder(BlockNormalBuilder):
    """The message-passing schedule from the compiled objective: the block
    layout of the sparse backend (uniform padded dof d, global variable
    ids per (bucket, slot), the flatten tables)."""

    def __init__(self, co: CompiledObjective, msg_iters: int = 30, msg_damping: float = 0.3,
                 ridge: float = 1e-6):
        super().__init__(co)
        self.msg_iters = int(msg_iters)
        self.msg_damping = float(msg_damping)
        self.opts_ridge = float(ridge)
        pat = self.pattern
        self.n, self.d = pat.n_vars, pat.d
        self.gvars = [[np.asarray(g) for g in gv] for gv in pat.bucket_gvars]
        for bi, gv in enumerate(self.gvars):
            k = len(gv)
            for s in range(k):
                for t in range(s + 1, k):
                    if np.any(gv[s] == gv[t]):
                        raise ValueError("GBP does not support a cost that references "
                                         f"the same variable in two slots (bucket {bi})")
        self.dof_mask_np = np.asarray(pat.dof_mask)  # (n, d)
        self.pad_eye_np = np.einsum("nd,de->nde", np.asarray(pat.pad_diag), np.eye(self.d))
        self._gbp_dev = {}

    def gv(self, bi: int, s: int, device) -> torch.Tensor:
        """Global variable ids (K,) of bucket bi's slot s on `device`
        (built once per device)."""
        key = ("gv", str(device))
        if key not in self._gbp_dev:
            self._gbp_dev[key] = [[torch.as_tensor(g, dtype=torch.long, device=device) for g in gv]
                                  for gv in self.gvars]
        return self._gbp_dev[key][bi][s]

    def scatter_plan(self, bi: int, s: int, device):
        """[(rows, ids)] that add bucket bi's slot-s values into their
        variables with no variable twice in one call: rows None (all K)
        when the slot's ids are distinct, else one entry per occurrence
        rank (a variable's first factor, its second, ...), in K order."""
        key = ("plan", str(device))
        if key not in self._gbp_dev:
            self._gbp_dev[key] = [[_scatter_plan(g, device) for g in gv] for gv in self.gvars]
        return self._gbp_dev[key][bi][s]

    def consts(self, device, dtype):
        """(dof_mask (n, d), pad_eye (n, d, d)) on `device`, built once."""
        key = (str(device), dtype)
        if key not in self._gbp_dev:
            self._gbp_dev[key] = (torch.as_tensor(self.dof_mask_np, dtype=dtype, device=device),
                                  torch.as_tensor(self.pad_eye_np, dtype=dtype, device=device))
        return self._gbp_dev[key]

    def build(self, state, aux, detach_hessian: bool = False) -> GBPNormal:
        blocks = self.co.linearize_blocks(state, aux)
        bsz = self.co.batch_size(state)
        dtype = self.co.state_dtype(state)
        lams, etas = [], []
        for jacs, werr in blocks:
            jp = [torch.nn.functional.pad(j, (0, self.d - j.shape[-1])) if j.shape[-1] < self.d else j
                  for j in jacs]  # (K, B, dim, dof) -> dof padded to d
            jh = [j.detach() for j in jp] if detach_hessian else jp
            k = len(jp)
            lams.append(tuple(tuple(torch.einsum("kbmi,kbmj->kbij", jh[s], jh[t]) for t in range(s, k))
                              for s in range(k)))
            etas.append(tuple(-torch.einsum("kbmi,kbm->kbi", j, werr) for j in jp))
        return GBPNormal(self, tuple(lams), tuple(etas), dtype, bsz)


class GaussianBeliefPropagation(NonlinearLeastSquares):
    """Nonlinear solve by relinearize, GBP sweeps, retract. On the carry
    protocol, so `TheseusLayer(GaussianBeliefPropagation(obj))` supports the
    four backward modes (the implicit and DLM steps solve through the same
    message-passing normal system)."""

    method = "gbp"

    def __init__(self, objective, msg_iters: int = 30, msg_damping: float = 0.3, gbp_ridge: float = 1e-6,
                 **kwargs):
        kwargs.setdefault("abs_err_tolerance", 1e-10)
        kwargs.setdefault("rel_err_tolerance", 1e-8)
        super().__init__(objective, **kwargs)
        self.opts = GBPOptions(
            msg_iters=msg_iters, msg_damping=msg_damping, gbp_ridge=gbp_ridge,
            **{f.name: getattr(self.opts, f.name) for f in dataclasses.fields(NLSOptions)},
        )

    @property
    def normal_builder(self) -> GBPNormalBuilder:
        co, nb, opts = self.compiled, self._normal_builder, self.opts
        if (nb is None or nb.co is not co or nb.msg_iters != opts.msg_iters
                or nb.msg_damping != opts.msg_damping or nb.opts_ridge != opts.gbp_ridge):
            self._normal_builder = GBPNormalBuilder(co, opts.msg_iters, opts.msg_damping, opts.gbp_ridge)
        return self._normal_builder

    def compute_delta(self, ns, damping, opts):
        return ns.solve(0.0, False, msg_iters=getattr(opts, "msg_iters", None),
                        msg_damping=getattr(opts, "msg_damping", None), ridge=getattr(opts, "gbp_ridge", None))

    def marginals(self, values=None, input_tensors=None) -> Dict[str, ManifoldGaussian]:
        """Solve, then each variable's posterior as a ManifoldGaussian: mean
        the solution, precision the GBP belief information in the tangent
        plane at the mean (exact on trees), which the direct solvers cannot
        give without a dense inverse."""
        out, _ = self.optimize(values=values, input_tensors=input_tensors)
        co = self.compiled
        bsz = co.resolve_batch_size(out)
        state = co.pack(out, bsz)
        aux = co.build_aux(out, bsz)
        bld = self.normal_builder
        with torch.no_grad():
            _, lam_v = bld.build(state, aux).marginals()
        res: Dict[str, ManifoldGaussian] = {}
        for i, name in enumerate(co.var_names):
            dv = int(bld.pattern.var_dofs[i])
            res[name] = ManifoldGaussian(mean=[out[name]], precision=lam_v[i][:, :dv, :dv], name=f"{name}_belief")
        return res
