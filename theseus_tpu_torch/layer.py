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
  differentiable iterations.

Each solve goes through `sparse_block_solve`, whose backward reuses the
forward's factor. "dlm" solves forward, but its backward is not ported:
inputs that require grad raise, as they do on the Schur linearization
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .config import check_no_grad
from .optim.nonlinear import NLSOptions, NonlinearLeastSquares, OptimizerInfo

BACKWARD_MODES = ("unroll", "implicit", "truncated", "dlm")


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

        if mode == "dlm":
            check_no_grad(*state.values(), *(t for b in aux for s in b for t in s))

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
        return carry  # dlm

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
