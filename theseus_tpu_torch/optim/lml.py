"""LML: the differentiable soft top-k (limited multi-label) projection (JAX counterpart: theseus_tpu/optim/lml.py).

From Amos et al., "The Limited Multi-Label Projection Layer": solve
sum_i sigmoid(x_i + nu) = n for nu per row (monotone: a bisection of fixed
length, then five Newton steps, all on the device with no host read-back),
y = sigmoid(x + nu). The backward is the closed-form implicit-function
adjoint, s * g - s <g, s> / sum(s) with s = y (1 - y).
"""

from __future__ import annotations

import torch


def _lml_forward(x, n: int, n_iter: int):
    m = x.shape[-1]
    if n >= m:
        return torch.ones_like(x)
    # the initial bracket: nu in [-max(x) - 20, -min(x) + 20]
    lo = -torch.amax(x, dim=-1) - 20.0
    hi = -torch.amin(x, dim=-1) + 20.0
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        below = torch.sum(torch.sigmoid(x + mid[..., None]), dim=-1) - n < 0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    nu = 0.5 * (lo + hi)
    for _ in range(5):  # Newton polish, g' = sum sigmoid'
        y = torch.sigmoid(x + nu[..., None])
        val = torch.sum(y, dim=-1) - n
        dval = torch.sum(y * (1 - y), dim=-1)
        nu = nu - val / torch.clamp(dval, min=1e-12)
    return torch.sigmoid(x + nu[..., None])


class _LML(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, n_iter):
        y = _lml_forward(x, n, n_iter)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, gbar):
        (y,) = ctx.saved_tensors
        s = y * (1 - y)
        ssum = torch.clamp(torch.sum(s, dim=-1, keepdim=True), min=1e-12)
        inner = torch.sum(gbar * s, dim=-1, keepdim=True)
        return s * gbar - s * inner / ssum, None, None


def lml(x, n: int, n_iter: int = 40):
    """x (..., m) -> y (..., m) with sum(y) ~= n, 0 < y < 1."""
    return _LML.apply(x, int(n), int(n_iter))
