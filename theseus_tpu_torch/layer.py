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
    def __init__(self, optimizer: NonlinearLeastSquares):
        self.optimizer = optimizer
        self.objective = optimizer.objective

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
        optimizer_kwargs.pop("verbose", None)
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
