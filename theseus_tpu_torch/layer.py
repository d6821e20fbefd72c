"""TheseusLayer: the optimization-layer API, forward solve (JAX counterpart: theseus_tpu/layer.py).

`forward(input_tensors)` packs the inputs, runs the inner optimizer and
unpacks the solution, under `torch.no_grad()`. The forward of the default
backward mode ("unroll": a fixed number of masked iterations) is the one
ported; the backward modes and their autograd Functions come next
(ROADMAP.md, queue 1), so an input that requires grad raises rather than
being detached silently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .config import check_no_grad
from .optim.nonlinear import NonlinearLeastSquares, OptimizerInfo

BACKWARD_MODES = ("unroll", "implicit", "truncated", "dlm")


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
        if mode != "unroll":
            raise NotImplementedError(
                f"backward_mode='{mode}' is not ported yet (ROADMAP.md, queue 1)"
            )
        optimizer_kwargs.pop("verbose", None)
        ignore_mask = optimizer_kwargs.pop("batch_ignore_mask", None)
        opts = (
            dataclasses.replace(self.optimizer.opts, **optimizer_kwargs)
            if optimizer_kwargs
            else self.optimizer.opts
        )
        values = self.objective.default_values(input_tensors)
        check_no_grad(*values.values())

        with torch.no_grad():
            co = self.objective.compile()
            bsz = co.resolve_batch_size(values)
            state = co.pack(values, bsz)
            aux = co.build_aux(values, bsz)
            opt = self.optimizer
            carry = opt.init_carry(state, aux, opts, ignore_mask)
            carry = opt.run_scan(carry, aux, opts.max_iterations, opts)
            info = opt.make_info(carry, opts)
            out = dict(values)
            out.update(co.unpack(carry["state"]))
        return out, info

    __call__ = forward
