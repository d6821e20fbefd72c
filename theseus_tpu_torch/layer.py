"""TheseusLayer: the differentiable optimization-layer API (JAX counterpart: theseus_tpu/layer.py).

`forward(input_tensors)` packs the inputs, runs the inner optimizer and
unpacks the solution. Gradients reach the inputs (poses, measurements,
weights) by the backward mode the caller picks:

- "unroll" (default): a fixed number of masked iterations with autograd
  recording through every one of them;
- "implicit": a no-grad early-exit solve to the fixed point, then one
  Gauss-Newton step with a detached Hessian and grad-carrying aux at step
  size 1.0: gradients flow through Atb only (the implicit-function adjoint);
- "truncated": a no-grad prefix, then `backward_num_iterations`
  differentiable iterations;
- "dlm" (direct loss minimization): one no-grad solve; its backward
  (`_DLMSolve`) recovers the aux gradient from two Gauss-Newton solves of
  the objective perturbed by +-eps times the normalized outer cotangent
  (central differences). The initial state gets a zero gradient. The
  perturbation moves the state by eps H^{-1} u: where H is large (bundle
  adjustment, the focal length squared) that falls below float32's
  resolution of the state and the float32 gradient is rounding noise.

Each solve goes through `sparse_block_solve` or the Schur solve, whose
backward reuses the forward's factor.

Beyond the solve: `compute_samples` (posterior samples around a solution,
the sparse path's backward sweep only), `compute_covariances` (exact
marginal covariances: unit-column solves with the block factor, one dense
inverse, or a GBP optimizer's belief blocks inverted) and
`verify_jacobians` (every analytic cost against autodiff).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .optim.nonlinear import NLSOptions, NonlinearLeastSquares, OptimizerInfo

BACKWARD_MODES = ("unroll", "implicit", "truncated", "dlm")
# the DLM finite-difference step along the unit tangent cotangent
DLM_EPSILON = 1e-2


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(v) for v in tree)
    return tree


class TheseusLayer:
    def __init__(self, optimizer: NonlinearLeastSquares, vectorize: bool = True):
        """vectorize=False compiles the objective with one bucket per cost
        (`Objective.compile(vectorize=False)`, kept for every later solve);
        True leaves the objective's compilation as it is."""
        self.optimizer = optimizer
        self.objective = optimizer.objective
        if not vectorize:
            self.objective.compile(vectorize=False)

    def forward(
        self,
        input_tensors: Optional[Dict] = None,
        optimizer_kwargs: Optional[Dict] = None,
    ) -> Tuple[Dict, OptimizerInfo]:
        optimizer_kwargs = dict(optimizer_kwargs or {})
        mode = str(optimizer_kwargs.pop("backward_mode", "unroll")).lower()
        if mode not in BACKWARD_MODES:
            raise ValueError(f"backward_mode must be one of {BACKWARD_MODES}")
        bwd_iters = int(optimizer_kwargs.pop("backward_num_iterations", 5))
        keep_step = bool(optimizer_kwargs.pop("__keep_final_step_size__", False))
        ignore_mask = optimizer_kwargs.pop("batch_ignore_mask", None)
        opts = (
            dataclasses.replace(self.optimizer.opts, **optimizer_kwargs)
            if optimizer_kwargs
            else self.optimizer.opts
        )
        values = self.objective.default_values(input_tensors)
        co = self.objective.compile()
        bsz = co.resolve_batch_size(values)
        state = co.pack(values, bsz)
        aux = co.build_aux(values, bsz)
        carry = self.solve_state(state, aux, mode, opts, bwd_iters, keep_step, ignore_mask)
        info = self.optimizer.make_info(carry, opts)
        out = dict(values)
        out.update(co.unpack(carry["state"]))
        return out, info

    __call__ = forward

    def solve_state(self, state, aux, mode: str, opts: NLSOptions,
                    backward_num_iterations: int = 5, keep_step_size: bool = False,
                    batch_ignore_mask=None):
        """The solve on packed state and aux; returns the final carry. Its
        state carries autograd history back to `state` and `aux` as `mode`
        defines."""
        opt = self.optimizer
        supported = getattr(opt, "supported_modes", BACKWARD_MODES)
        if mode not in supported:
            raise ValueError(
                f"{type(opt).__name__} supports backward modes {supported}, "
                f"got '{mode}' (gradient-based modes need a linearization)"
            )
        mask = batch_ignore_mask
        if mode == "unroll":
            carry = opt.init_carry(state, aux, opts, mask)
            return opt.run_scan(carry, aux, opts.max_iterations, opts)

        sg_state, sg_aux = _detach(state), _detach(aux)
        n_nograd = opts.max_iterations
        if mode == "truncated":
            n_nograd = max(opts.max_iterations - backward_num_iterations, 0)
        with torch.no_grad():
            carry = opt.init_carry(sg_state, sg_aux, opts, mask)
            carry = opt.run_while(carry, sg_aux, n_nograd, opts)

        if mode == "implicit":
            step_size = None if keep_step_size else 1.0
            return self._implicit_final_step(carry, aux, opts, step_size, mask)
        if mode == "truncated":
            # convergence restarts for the differentiable phase (the JAX
            # package's rule): only user-frozen elements stay frozen
            carry = dict(carry)
            carry["done"] = carry["ignore"]
            return opt.run_scan(carry, aux, min(backward_num_iterations, opts.max_iterations), opts)
        # dlm: the solution passes through _DLMSolve, which takes state and
        # aux as inputs so that autograd reaches them
        keys = tuple(carry["state"])
        leaves = [t for b in aux for slots in b for t in slots]
        sol = _DLMSolve.apply(self, mask, (keys, [[len(s) for s in b] for b in aux]),
                              *carry["state"].values(), *(state[k] for k in keys), *leaves)
        carry = dict(carry)
        carry["state"] = dict(zip(keys, sol))
        return carry

    def _implicit_final_step(self, carry, aux, opts, step_size, mask=None):
        """One Gauss-Newton step from the detached solution with AtA detached
        and Atb carrying the graph of `aux`."""
        co = self.objective.compile()
        state = carry["state"]
        ns = self.optimizer.normal_builder.build(state, aux, detach_hessian=True)
        delta, _ = ns.solve(0.0, False)
        ss = opts.step_size if step_size is None else step_size
        accept = None if mask is None else ~torch.as_tensor(mask, dtype=torch.bool, device=delta.device)
        new_state = co.retract(state, ss * delta, accept=accept)
        out = dict(carry)
        out["state"] = new_state
        out["err"] = co.error_metric(new_state, aux)
        return out


    # ------------------------------------------------------------------
    def _packed(self, values, input_tensors):
        co = self.objective.compile()
        values = values or self.objective.default_values(input_tensors)
        bsz = co.resolve_batch_size(values)
        return co, bsz, co.pack(values, bsz), co.build_aux(values, bsz)

    def _dense_normal(self, co, ns, state, aux):
        """ns itself if it holds a dense AtA, else the dense system (the
        Schur path's samples and covariances)."""
        if hasattr(ns, "AtA"):
            return ns
        from .optim.linear import DenseCholeskySolver
        from .optim.normal import DenseNormalBuilder

        return DenseNormalBuilder(co, self.optimizer.linear_solver or DenseCholeskySolver()).build(state, aux)

    def compute_samples(self, values=None, input_tensors=None, n_samples: int = 10,
                        temperature: float = 1.0, generator: Optional[torch.Generator] = None):
        """Posterior samples around the current solution (no gradient):
        x ~ N(x + delta, temperature (AtA)^{-1}), drawn as
        delta + sqrt(T) L^{-T} y with AtA = L L^T and y standard normal from
        `generator` (drawn on its device, moved to the problem's). The
        sparse path factors the block AtA with the level kernels and runs
        the backward sweep only (`sample_with_factor`), all samples folded
        into the batch: one sweep of launches; the dense and Schur paths
        take the dense AtA's `cholesky_ex` and one triangular solve.
        Returns {name: (B, n_samples, *shape)}."""
        from .lie.utils import draw
        from .optim.normal import SparseNormal
        from .sparse.cholesky import factorize, sample_with_factor

        co, bsz, state, aux = self._packed(values, input_tensors)
        sqrt_t = float(temperature) ** 0.5
        dev = co.device
        with torch.no_grad():
            ns = self.optimizer.normal_builder.build(state, aux)
            if isinstance(ns, SparseNormal) and ns.builder.sched is not None:  # not PCG
                bld = ns.builder
                delta, _ = ns.solve(0.0, False)  # (B, D)
                lflat = factorize(bld.sched, ns.ata)
                n_blk, d = bld.pattern.n_vars, bld.pattern.d
                ys = draw(True, (n_samples, n_blk, bsz, d), generator, delta.dtype, dev)
                # samples folded into the batch, sample-major: s * B + b
                y = ys.movedim(0, 1).reshape(n_blk, n_samples * bsz, d)
                x = sample_with_factor(bld.sched, lflat.repeat(1, n_samples, 1, 1), y)
                pert = bld.flatten(x).reshape(n_samples, bsz, -1).permute(1, 2, 0)  # (B, D, S)
            else:
                ns = self._dense_normal(co, ns, state, aux)
                delta, _ = ns.solve(0.0, False)
                chol, info = torch.linalg.cholesky_ex(ns.AtA)
                chol = torch.where((info != 0)[:, None, None], torch.nan, chol)
                y = draw(True, (bsz, co.total_dof, n_samples), generator, delta.dtype, dev)
                # L^T x = y: x ~ N(0, (L L^T)^{-1})
                pert = torch.linalg.solve_triangular(chol.mT, y, upper=True)
            deltas = delta[..., None] + sqrt_t * pert  # (B, D, S)
            # every sample retracted at once: batch b * S + s
            rep = {tk: t.repeat_interleave(n_samples, dim=1) for tk, t in state.items()}
            flat = deltas.permute(0, 2, 1).reshape(bsz * n_samples, -1)
            sampled = co.retract(rep, flat)
            sampled = {tk: t.reshape((t.shape[0], bsz, n_samples) + tuple(t.shape[2:])) for tk, t in sampled.items()}
        return co.unpack(sampled)

    def compute_covariances(self, values=None, input_tensors=None, var_names=None, damping: float = 0.0):
        """Exact marginal covariances of the Gauss-Newton posterior at
        `values`: cov_i = (H^{-1})_{ii}, H = J^T W J + damping I (no
        gradient). The sparse path factors the damped block H once and
        solves H x = e for the dof unit columns of each requested variable
        (folded into the batch: one factor-reusing solve, both level sweeps,
        per variable); a Gaussian-belief-propagation optimizer inverts each
        variable's belief precision (exact on trees); the dense, Schur and
        PCG paths invert H once. Returns {name: (B, dof, dof)}."""
        from .optim.normal import SparseNormal
        from .sparse.assemble import apply_block_damping
        from .sparse.cholesky import factorize, solve_with_factor

        co, bsz, state, aux = self._packed(values, input_tensors)
        names = list(var_names) if var_names else list(co.var_names)
        var_index = {n: i for i, n in enumerate(co.var_names)}
        out = {}
        with torch.no_grad():
            ns = self.optimizer.normal_builder.build(state, aux)
            if hasattr(ns, "marginals"):  # GBP: each variable's belief
                _, lam_v = ns.marginals(damping)
                for name in names:
                    i, dv = var_index[name], co.var_groups[name].dof
                    cov, info = torch.linalg.inv_ex(lam_v[i][:, :dv, :dv])
                    out[name] = torch.where((info != 0)[:, None, None], torch.nan, cov)
                return out
            if isinstance(ns, SparseNormal) and ns.builder.sched is not None:  # not PCG
                bld = ns.builder
                ata = apply_block_damping(bld.pattern, ns.ata, damping, False, bld.damping_eps)
                lflat = factorize(bld.sched, ata)
                n_blk, d = bld.pattern.n_vars, bld.pattern.d
                for name in names:
                    i, dv = var_index[name], co.var_groups[name].dof
                    # unit column c of variable i in batch slot c * B + b
                    rhs = torch.zeros((n_blk, dv, bsz, d), dtype=ata.dtype, device=ata.device)
                    rhs[i, torch.arange(dv), :, torch.arange(dv)] = 1.0
                    x = solve_with_factor(bld.sched, lflat.repeat(1, dv, 1, 1), rhs.reshape(n_blk, dv * bsz, d))
                    cov = x[i].reshape(dv, bsz, d)[..., :dv].movedim(0, 1)  # (B, column, row)
                    out[name] = 0.5 * (cov + cov.mT)
                return out
            h = self._dense_normal(co, ns, state, aux).AtA
            if damping:
                h = h + damping * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
            cov_full, _ = torch.linalg.inv_ex(h)
            for name in names:
                o, dv = co.col_offset[name], co.var_groups[name].dof
                out[name] = cov_full[:, o:o + dv, o:o + dv]
        return out

    def verify_jacobians(self, num_checks: int = 1, tol: float = 1e-3) -> bool:
        """Check the analytic jacobians of every cost function (cost
        families excepted) against autodiff; prints each failure."""
        from .core.cost_function import CostFunction
        from .utils.checks import check_jacobians

        ok = True
        for cf in self.objective.cost_functions.values():
            if not isinstance(cf, CostFunction):
                continue
            try:
                check_jacobians(cf, num_checks=num_checks, tol=tol, device=self.objective.device)
            except RuntimeError as e:
                print(f"Jacobian check failed for {cf.name}: {e}")
                ok = False
        return ok


def _rebuild_aux(layout, leaves):
    """Flat aux leaves -> the per-bucket ((cf aux), (weight aux)) tuples."""
    it = iter(leaves)
    return tuple(tuple(tuple(next(it) for _ in range(n)) for n in bucket) for bucket in layout)


def _state_cotangent_to_tangent(co, state, g):
    """An ambient cotangent on the state ({type: (N, B, *shape)}) as a
    tangent-space vector (B, D), by each group's egrad_to_tangent."""
    some = next(iter(state.values()))
    out = torch.zeros((co.batch_size(state), co.total_dof), dtype=some.dtype, device=some.device)
    for tk in co.type_members:
        tang = co.groups_by_type[tk].egrad_to_tangent(state[tk], g[tk])  # (N, B, dof)
        out[:, co._index(co.type_cols[tk], out.device)] = tang.movedim(0, 1)
    return out


class _DLMSolve(torch.autograd.Function):
    """The DLM backward (the JAX package's `_dlm_solve_bwd`) around a solve
    that already ran.

    Inputs: the solution state, the initial state (the same keys) and the
    flat aux leaves; forward returns the solution. Backward, with g the
    cotangent of the solution: one detached-Hessian normal system at the
    solution; g mapped
    to the tangent space, zeroed on frozen batch elements and normalized
    per element to u; x_+- = retract(x*, H^{-1}(Atb -+ eps u)); each
    element weighted by ||g||/(2 eps); the aux gradient is that of the
    weighted error metric at x_+ minus at x_- (one autograd pass over the
    per-residual difference). The initial state's gradient is zero."""

    @staticmethod
    def forward(ctx, layer, mask, layout, *tensors):
        keys, aux_layout = layout
        n = len(keys)
        ctx.layer, ctx.mask, ctx.keys, ctx.aux_layout = layer, mask, keys, aux_layout
        ctx.save_for_backward(*tensors[:n], *tensors[2 * n:])
        return tuple(t.clone() for t in tensors[:n])

    @staticmethod
    def backward(ctx, *g):
        co = ctx.layer.objective.compile()
        n = len(ctx.keys)
        saved = ctx.saved_tensors
        sol, aux_leaves = dict(zip(ctx.keys, saved[:n])), saved[n:]
        wants = ctx.needs_input_grad[3 + 2 * n:]
        with torch.no_grad():
            ns = ctx.layer.optimizer.normal_builder.build(sol, _rebuild_aux(ctx.aux_layout, aux_leaves),
                                                          detach_hessian=True)
            gt = _state_cotangent_to_tangent(co, sol, dict(zip(ctx.keys, g)))
            if ctx.mask is not None:  # frozen elements: no perturbation
                frozen = torch.as_tensor(ctx.mask, dtype=torch.bool, device=gt.device)
                gt = torch.where(frozen[:, None], torch.zeros_like(gt), gt)
            gnorm = torch.linalg.vector_norm(gt, dim=-1, keepdim=True)
            u = gt / torch.where(gnorm > 0, gnorm, torch.ones_like(gnorm))
            x_plus = co.retract(sol, ns.solve(0.0, False, rhs_shift=DLM_EPSILON * u)[0])
            x_minus = co.retract(sol, ns.solve(0.0, False, rhs_shift=-DLM_EPSILON * u)[0])
            w = gnorm[:, 0] / (2.0 * DLM_EPSILON)
        leaves = [a.detach().requires_grad_(bool(want)) for a, want in zip(aux_leaves, wants)]
        grads = iter(())
        if any(wants):
            with torch.enable_grad():
                aux = _rebuild_aux(ctx.aux_layout, leaves)
                # the weighted error metric at x_+ minus at x_-, formed per
                # residual as 0.5 (e_+ - e_-)(e_+ + e_-): the difference is
                # O(eps) of each metric, which a difference of the two sums
                # would lose to cancellation in float32
                e_plus, e_minus = co.error(x_plus, aux), co.error(x_minus, aux)
                outer = 0.5 * torch.sum(w[:, None] * (e_plus - e_minus) * (e_plus + e_minus))
                grads = iter(torch.autograd.grad(outer, [a for a in leaves if a.requires_grad], allow_unused=True))
        state_in = ctx.needs_input_grad[3 + n: 3 + 2 * n]
        zeros = [torch.zeros_like(t) if want else None for t, want in zip(sol.values(), state_in)]
        return ((None, None, None) + (None,) * n + tuple(zeros)
                + tuple(next(grads) if want else None for want in wants))
