"""Manifold-aware first-order updates for outer-loop learning (JAX counterpart: theseus_tpu/optim/manifold_optax.py, whose name this module keeps).

Gradients on group-valued leaves are pulled back to the tangent space by
`egrad_to_tangent`, a `torch.optim` optimizer (Adam, SGD, ...) runs on
tangent-space parameters, and its update is applied by `retract`; other
leaves update additively. PyTorch's Adam and optax's use the same update
(bias-corrected moments, eps outside the square root), so trajectories
agree with the JAX package's `lie_optimizer(groups, optax.adam(lr))`.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..lie import Group


def manifold_update(group: Group, param, egrad, step_size: float):
    """One manifold SGD step: retract(g, -lr * egrad_to_tangent(g, egrad))."""
    tangent_grad = group.egrad_to_tangent(param, egrad)
    return group.retract(param, -step_size * tangent_grad)


class LieTx:
    """The optax-style triple of the JAX package over a torch optimizer:

        tx = lie_optimizer({"pose": lie.SE3}, lambda ps: torch.optim.Adam(ps, lr=1e-2))
        state = tx.init(params)
        updates, state = tx.update(grads, state, params)
        params = tx.apply(params, updates)

    `state` is the torch optimizer over zero-valued tangent parameters (one
    per leaf: (*batch, dof) for a group leaf, the leaf's shape otherwise);
    `update` hands it the projected gradients, takes one step and reads the
    step back as the update, resetting the parameters to zero."""

    def __init__(self, groups: Dict[str, Group], optimizer_factory: Callable):
        self.groups = dict(groups)
        self.optimizer_factory = optimizer_factory
        self._tangent = {}

    def _tangent_shape(self, k, p):
        g = self.groups.get(k)
        if g is None:
            return tuple(p.shape)
        return tuple(p.shape[: p.dim() - len(g.shape)]) + (g.dof,)

    def init(self, params):
        self._tangent = {k: torch.zeros(self._tangent_shape(k, p), dtype=p.dtype, device=p.device,
                                        requires_grad=True) for k, p in params.items()}
        return self.optimizer_factory(list(self._tangent.values()))

    def update(self, grads, state, params):
        for k, t in self._tangent.items():
            g = self.groups.get(k)
            t.grad = (grads[k] if g is None else g.egrad_to_tangent(params[k], grads[k])).detach().clone()
        state.step()
        updates = {}
        with torch.no_grad():
            for k, t in self._tangent.items():
                updates[k] = t.detach().clone()
                t.zero_()
                t.grad = None
        return updates, state

    def apply(self, params, updates):
        return {k: (self.groups[k].retract(v, updates[k]) if k in self.groups else v + updates[k])
                for k, v in params.items()}


def lie_optimizer(groups: Dict[str, Group], optimizer_factory: Callable) -> LieTx:
    """Leaves named in `groups` live on their manifold; optimizer_factory
    maps a list of tangent parameters to a torch.optim optimizer."""
    return LieTx(groups, optimizer_factory)
