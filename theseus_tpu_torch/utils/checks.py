"""Verification utilities: analytic-against-autodiff jacobian checks, manifold-aware numeric differentiation, and the small MLP of the learning-loop examples (JAX counterpart: theseus_tpu/utils/checks.py).

The autodiff ground truth is torch.func.jacfwd through the retract at a
zero tangent, which is exact; central differences are provided for an
independent check.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import resolve_device


def numeric_jacobian(fn: Callable, groups: Sequence, elements: Sequence, h: float = 1e-6):
    """Central-difference jacobians of fn(elements) -> (dim,) with respect
    to each element's right tangent: a list of numpy (dim, dof) arrays."""
    jacs = []
    for s, (g, x) in enumerate(zip(groups, elements)):
        cols = []
        for i in range(g.dof):
            e = torch.zeros(g.dof, dtype=x.dtype, device=x.device)
            e[i] = h
            ep, em = list(elements), list(elements)
            ep[s], em[s] = g.retract(x, e), g.retract(x, -e)
            diff = np.asarray(fn(tuple(ep)).detach().cpu()) - np.asarray(fn(tuple(em)).detach().cpu())
            cols.append(diff / (2 * h))
        jacs.append(np.stack(cols, axis=-1))
    return jacs


def autodiff_jacobian(fn: Callable, groups: Sequence, elements: Sequence):
    """Exact tangent jacobians of fn(elements) -> (dim,) by torch.func.jacfwd
    through the retract at zero: a list of (dim, dof) tensors."""

    def at(*deltas):
        return fn(tuple(g.retract(x, d) for g, x, d in zip(groups, elements, deltas)))

    zeros = tuple(elements[0].new_zeros(g.dof) for g in groups)
    return list(torch.func.jacfwd(at, argnums=tuple(range(len(groups))))(*zeros))


def check_jacobians(cost_function, num_checks: int = 1, tol: float = 1e-6,
                    generator: Optional[torch.Generator] = None, verbose: bool = False,
                    device=None) -> bool:
    """Compare a cost function's analytic jacobians with autodiff at random
    variable values, in float64; raises RuntimeError on a mismatch. A cost
    without analytic jacobians passes. The analytic functions take stacked
    buckets, so the elements enter as one instance of batch 1, with each
    aux variable's first batch element as a shared operand."""
    if not cost_function.has_analytic_jacobians:
        return True
    device = resolve_device(device)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    groups = [v.group for v in cost_function.optim_vars]
    if any(a.tensor is None for a in cost_function.aux_vars):
        raise ValueError("All aux vars need data for check_jacobians.")
    aux = tuple(torch.as_tensor(np.asarray(a.tensor) if not isinstance(a.tensor, torch.Tensor) else a.tensor)
                .to(device=device, dtype=torch.float64)[:1] for a in cost_function.aux_vars)

    def error_one(optim):
        return cost_function.error_impl(tuple(x[None, None] for x in optim), aux)[0, 0]

    for chk in range(num_checks):
        elements = tuple(g.rand(generator=generator, dtype=torch.float64, device=device) for g in groups)
        jacs_a, _ = cost_function.jacobians_impl(tuple(x[None, None] for x in elements), aux)
        jacs_n = autodiff_jacobian(error_one, groups, elements)
        for s, (ja, jn) in enumerate(zip(jacs_a, jacs_n)):
            diff = float((ja[0, 0] - jn).abs().max())
            if verbose:
                print(f"check {chk} slot {s}: max diff {diff:.3e}")
            if diff > tol:
                raise RuntimeError(
                    f"Jacobian mismatch for {cost_function.name} optim var {s}: "
                    f"max abs diff {diff:.3e} > {tol:.1e}"
                )
    return True


def gather_from_rows_cols(matrix: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """matrix (B, H, W), rows and cols (B, N) -> (B, N)."""
    return torch.gather(matrix.reshape(matrix.shape[0], -1), 1, rows * matrix.shape[-1] + cols)


class MLP(nn.Module):
    """Layers x @ w + b (w (n_in, n_out), the JAX package's layout, so that
    its parameters carry across), the activation between layers."""

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 activation: Callable = torch.relu):
        super().__init__()
        self.weights = nn.ParameterList([nn.Parameter(w) for w in weights])
        self.biases = nn.ParameterList([nn.Parameter(b) for b in biases])
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i + 1 < n:
                x = self.activation(x)
        return x


def build_mlp(hidden_sizes: Sequence[int], generator: torch.Generator, activation: Callable = torch.relu,
              dtype: torch.dtype = torch.float32, device=None) -> MLP:
    """An MLP with layer sizes `hidden_sizes`: He-normal weights
    (sqrt(2 / n_in) times a standard normal, drawn in float64 from
    `generator` on its device, so that every dtype and device gets the same
    weights) and zero biases."""
    device = resolve_device(device)
    weights, biases = [], []
    for n_in, n_out in zip(hidden_sizes[:-1], hidden_sizes[1:]):
        w = torch.randn((n_in, n_out), generator=generator, dtype=torch.float64, device=generator.device)
        weights.append((float(np.sqrt(2.0 / n_in)) * w).to(device=device, dtype=dtype))
        biases.append(torch.zeros((n_out,), dtype=dtype, device=device))
    return MLP(weights, biases, activation)
