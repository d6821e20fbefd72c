"""Robust loss functions rho(x) and their IRLS factors rho'(x) (JAX counterpart: theseus_tpu/core/robust_loss.py).

`x` is the squared norm ||w e||^2 (or one squared entry, per dimension);
`log_radius` sets the radius as exp(log_radius), so that an outer loop can
learn it unconstrained. The GNC loss (Geman-McClure) takes an annealing
control `mu` as well. Every function is elementwise on tensors and
broadcasts; each `torch.where` keeps the JAX package's `maximum` guards, so
that the branch not taken never makes a NaN gradient.
"""

from __future__ import annotations

import torch

LOSS_EPS = 1e-20


def _radius(x: torch.Tensor, log_radius) -> torch.Tensor:
    return torch.exp(torch.as_tensor(log_radius, dtype=x.dtype, device=x.device))


class WelschLoss:
    is_gnc = False

    @staticmethod
    def evaluate(x, log_radius):
        radius = _radius(x, log_radius)
        return radius - radius * torch.exp(-x / (radius + LOSS_EPS))

    @staticmethod
    def linearize(x, log_radius):
        radius = _radius(x, log_radius)
        return torch.exp(-x / (radius + LOSS_EPS))


class HuberLoss:
    is_gnc = False

    @staticmethod
    def evaluate(x, log_radius):
        radius = _radius(x, log_radius)
        return torch.where(x > radius, 2.0 * torch.sqrt(radius * torch.maximum(x, radius) + LOSS_EPS) - radius, x)

    @staticmethod
    def linearize(x, log_radius):
        radius = _radius(x, log_radius)
        return torch.sqrt(radius / torch.maximum(x, radius) + LOSS_EPS)


class HingeLoss:
    is_gnc = False

    @staticmethod
    def evaluate(x, log_radius):
        radius = _radius(x, log_radius)
        return torch.where(x > radius, torch.sqrt(torch.clamp(x, min=LOSS_EPS)) - torch.sqrt(radius), LOSS_EPS)

    @staticmethod
    def linearize(x, log_radius):
        radius = _radius(x, log_radius)
        return torch.where(x > radius, 1.0 / (2.0 * torch.sqrt(torch.clamp(x, min=LOSS_EPS)) + LOSS_EPS), 0.0)


class GemanMcClureLoss:
    """GNC-capable: mu from 1 (the full Geman-McClure loss) to +inf
    (quadratic)."""

    is_gnc = True

    @staticmethod
    def evaluate(x, log_radius, mu=1.0):
        radius = _radius(x, log_radius)
        return mu * radius * x / (mu * radius + x + LOSS_EPS)

    @staticmethod
    def linearize(x, log_radius, mu=1.0):
        radius = _radius(x, log_radius)
        return (mu * radius) ** 2 / ((mu * radius + x) ** 2 + LOSS_EPS)
