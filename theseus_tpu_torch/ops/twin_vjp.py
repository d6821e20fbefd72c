"""Autograd for a kernel without a backward kernel (JAX counterpart: the `_fused_bwd` of theseus_tpu/ops/pallas_*.py).

`kernel_with_twin_vjp(forward, plain, *ops)` returns `forward(*ops)`. While
autograd records, the call goes through `_TwinVJP`, whose forward is that
same call and whose backward is the VJP of `plain` at the saved inputs, as
the JAX package's `_fused_bwd` takes `jax.vjp` of `_reference_linearize`.
The Between and Reprojection linearizations share it.
"""

from __future__ import annotations

import torch

from ..config import needs_grad
from ..tracing import span


class _TwinVJP(torch.autograd.Function):
    """Forward: `forward(*ops)`. Backward: the VJP of `plain` at the saved
    inputs."""

    @staticmethod
    def forward(ctx, forward, plain, *ops):
        ctx.plain = plain
        ctx.save_for_backward(*ops)
        return forward(*ops)

    @staticmethod
    def backward(ctx, *cots):
        with span("tt.backward.vjp"):
            wants = ctx.needs_input_grad[2:]
            prims = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wants)]
            with torch.enable_grad():
                outs = ctx.plain(*prims)
            leaves = [p for p, w in zip(prims, wants) if w]
            grads = iter(torch.autograd.grad(outs, leaves, cots, allow_unused=True))
            return (None, None) + tuple(next(grads) if w else None for w in wants)


def kernel_with_twin_vjp(forward, plain, *ops):
    """`forward(*ops)`, through `_TwinVJP` when an input requires grad."""
    if needs_grad(*ops):
        return _TwinVJP.apply(forward, plain, *ops)
    return forward(*ops)
