"""Cost functions: weighted residual terms over manifold variables (JAX counterpart: theseus_tpu/core/cost_function.py).

Two contracts, chosen by `has_analytic_jacobians`:

- analytic (True: Between, Local, Reprojection, ...): `error_impl(optim,
  aux)` and `jacobians_impl(optim, aux)` take whole stacked buckets: every
  optim operand is (K, B, *shape) and every aux operand (K, B, ...) or,
  when all members of the bucket share it, (B, ...); torch broadcasting
  does what the JAX package's vmap over instances and batch did;
- autodiff (False: `AutoDiffCostFunction`, or a subclass that defines only
  `error_impl`): `error_impl` is the JAX contract, one instance and one
  batch element, (optim elements, aux elements) -> (dim,); the compiled
  objective maps it with torch.func.vmap, and `jacobians_fn` gives its
  tangent-space jacobians by torch.func.jacfwd (or jacrev) through the
  retract at delta = 0.

`RobustCostFunction` and `GNCRobustCostFunction` wrap a cost of either kind
with a robust loss; the compiled objective applies the loss to the wrapped
cost's weighted outputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .cost_weight import CostWeight, ScaleCostWeight
from .robust_loss import LOSS_EPS
from .variable import ManifoldVariable, Variable, as_variable


class CostFunction:
    """Base class. Subclasses define `dim`, `error_impl` and, with
    has_analytic_jacobians, the analytic `jacobians_impl` (right-tangent
    jacobians) over stacked buckets; without it `error_impl` is per
    instance and the jacobians come from `jacobians_fn`."""

    has_analytic_jacobians = False

    def __init__(
        self,
        optim_vars: Sequence[ManifoldVariable],
        aux_vars: Sequence[Variable] = (),
        cost_weight: Optional[CostWeight] = None,
        name: Optional[str] = None,
    ):
        if len(optim_vars) < 1:
            raise ValueError("At least one optimization variable is required.")
        for v in optim_vars:
            if not isinstance(v, ManifoldVariable):
                raise TypeError(f"Optim var {v} must be a ManifoldVariable.")
        self.optim_vars: Tuple[ManifoldVariable, ...] = tuple(optim_vars)
        self.aux_vars: Tuple[Variable, ...] = tuple(as_variable(a) for a in aux_vars)
        self.weight: CostWeight = cost_weight or ScaleCostWeight(1.0)
        self.name = name or f"{type(self).__name__}__{id(self)}"

    def dim(self) -> int:
        raise NotImplementedError

    def error_impl(self, optim: Tuple, aux: Tuple):
        """Analytic: stacked optim and aux operands -> (K, B, dim).
        Autodiff: one instance's elements -> (dim,)."""
        raise NotImplementedError

    def jacobians_impl(self, optim: Tuple, aux: Tuple):
        """Returns (list over optim slots of (K, B, dim, dof), err (K, B, dim))."""
        raise NotImplementedError

    def jacobians_fn(self) -> Callable:
        """The autodiff jacobians of the per-instance `error_impl`: a fn
        (optim, aux) -> (list over slots of (dim, dof), err (dim,)) that
        differentiates error(retract(x, delta)) at delta = 0, so that the
        jacobians are in the right tangent space. `autograd_mode` "fwd"
        (torch.func.jacfwd, the default; right when dim >= the total dof) or
        "rev" (jacrev, for a low-dim residual over large variables). The
        Lie exp/log inside take their analytic JVP rule, as under the JAX
        package's custom_jvp."""
        groups = tuple(v.group for v in self.optim_vars)
        fwd = getattr(self, "autograd_mode", "fwd") != "rev"
        jac_op = torch.func.jacfwd if fwd else torch.func.jacrev

        def jfn(optim, aux):
            # torch.func.jvp gives a 0-d float32 tensor combined with a Python
            # scalar (0.5 * theta) a float64 tangent, and a float32 cost then
            # mixes dtypes inside (an SE2 retract's theta is 0-d per
            # instance): forward mode below float64 runs in float64 and
            # rounds its results back
            dtype = optim[0].dtype
            up = fwd and dtype != torch.float64
            if up:
                optim = tuple(x.double() for x in optim)
                aux = tuple(a.double() if a.is_floating_point() else a for a in aux)

            def at(*deltas):
                err = self.error_impl(tuple(g.retract(x, d) for g, x, d in zip(groups, optim, deltas)), aux)
                return err, err

            zeros = tuple(optim[0].new_zeros(g.dof) for g in groups)
            jacs, err = jac_op(at, argnums=tuple(range(len(groups))), has_aux=True)(*zeros)
            if up:
                return [j.to(dtype) for j in jacs], err.to(dtype)
            return list(jacs), err

        return jfn

    def schema(self):
        """Costs with equal schema are evaluated together as one bucket."""
        return (
            type(self).__name__,
            tuple(v.group.name for v in self.optim_vars),
            tuple(None if a.tensor is None else tuple(a.tensor.shape[1:]) for a in self.aux_vars),
            self.weight.schema(),
            self.dim(),
        )

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name}, dim={self.dim()})"


class AutoDiffCostFunction(CostFunction):
    """A user residual `err_fn(optim, aux) -> (dim,)` written for one
    instance and one batch element (the JAX package's contract); the
    compiled objective maps it over instances and batch with
    torch.func.vmap and differentiates it by `jacobians_fn`."""

    def __init__(
        self,
        optim_vars: Sequence[ManifoldVariable],
        dim: int,
        err_fn: Callable,
        aux_vars: Sequence[Variable] = (),
        cost_weight: Optional[CostWeight] = None,
        name: Optional[str] = None,
        autograd_mode: str = "fwd",
    ):
        super().__init__(optim_vars, aux_vars, cost_weight, name)
        if autograd_mode not in ("fwd", "rev"):
            raise ValueError("autograd_mode must be 'fwd' or 'rev'")
        self._dim = dim
        self._err_fn = err_fn
        self.autograd_mode = autograd_mode

    def dim(self) -> int:
        return self._dim

    def error_impl(self, optim, aux):
        return self._err_fn(optim, aux)

    def schema(self):
        """Costs bucket together only with the same err_fn and mode."""
        return super().schema() + (id(self._err_fn), self.autograd_mode)


def _as_batched_scalar(value) -> Variable:
    """A user scalar (Python or numpy float, 0-d or 1-d array) as a (1, 1)
    or (B, 1) aux Variable: every aux operand carries a leading batch axis."""
    v = as_variable(value)
    t = v.tensor
    if t is not None:
        if t.ndim == 0:
            v.tensor = t.reshape(1, 1)
        elif t.ndim == 1:  # (B,) -> (B, 1): 1-d means per-batch values
            v.tensor = t.reshape(-1, 1)
    return v


def _trailing(x):
    """Per-cost scalar (..., K, B) -> (..., K, B, 1), to meet (K, B, dim)."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


class RobustCostFunction(CostFunction):
    """A cost with a robust loss rho applied to ||w e||^2.

    The weighted error reported for metrics is ones * sqrt(rho / dim), so
    that its sum of squares is the loss; the linearization rescales the
    weighted error and jacobians by sqrt(rho') (the Triggs correction with
    alpha = 0). With flatten_dims the loss applies to each dimension's
    squared entry instead. The log radius is the last aux variable."""

    def __init__(
        self,
        cost_function: CostFunction,
        loss_cls,
        log_loss_radius,
        flatten_dims: bool = False,
        name: Optional[str] = None,
    ):
        log_loss_radius = _as_batched_scalar(log_loss_radius)
        super().__init__(
            cost_function.optim_vars,
            tuple(cost_function.aux_vars) + (log_loss_radius,),
            cost_function.weight,
            name or f"Robust__{cost_function.name}",
        )
        self.cost_function = cost_function
        self.loss_cls = loss_cls
        self.log_loss_radius = log_loss_radius
        self.flatten_dims = flatten_dims

    @property
    def has_analytic_jacobians(self):
        return self.cost_function.has_analytic_jacobians

    def dim(self) -> int:
        return self.cost_function.dim()

    def inner_aux(self, aux):
        """The wrapped cost's aux operands."""
        return aux[: len(self.cost_function.aux_vars)]

    def error_impl(self, optim, aux):
        return self.cost_function.error_impl(optim, self.inner_aux(aux))

    def jacobians_impl(self, optim, aux):
        return self.cost_function.jacobians_impl(optim, self.inner_aux(aux))

    def robust_apply_error(self, werr, log_radius, mu=None):
        """Metric-mode transform of the weighted error (K, B, dim)."""
        if self.flatten_dims:
            return torch.sqrt(self._loss_eval(werr**2, _trailing(log_radius), _trailing(mu)) + LOSS_EPS)
        loss = self._loss_eval(torch.sum(werr**2, dim=-1), log_radius, mu)
        return torch.ones_like(werr) * torch.sqrt(loss / self.dim() + LOSS_EPS)[..., None]

    def robust_rescale(self, werr, log_radius, mu=None):
        """sqrt(rho') factors for the linearization: (K, B) per cost, or
        (K, B, dim) with flatten_dims."""
        if self.flatten_dims:
            return torch.sqrt(self._loss_lin(werr**2, _trailing(log_radius), _trailing(mu)) + LOSS_EPS)
        return torch.sqrt(self._loss_lin(torch.sum(werr**2, dim=-1), log_radius, mu) + LOSS_EPS)

    def _loss_eval(self, x, log_radius, mu):
        if self.loss_cls.is_gnc:
            return self.loss_cls.evaluate(x, log_radius, 1.0 if mu is None else mu)
        return self.loss_cls.evaluate(x, log_radius)

    def _loss_lin(self, x, log_radius, mu):
        if self.loss_cls.is_gnc:
            return self.loss_cls.linearize(x, log_radius, 1.0 if mu is None else mu)
        return self.loss_cls.linearize(x, log_radius)

    def schema(self):
        return ("Robust", self.loss_cls.__name__, self.flatten_dims, self.cost_function.schema())


class GNCRobustCostFunction(RobustCostFunction):
    """A robust cost with a graduated-non-convexity control mu as one more
    aux variable: an outer loop anneals mu from large (near quadratic)
    toward 1 (the full robust loss). Aux: the wrapped cost's, then the log
    radius, then mu."""

    def __init__(self, cost_function, loss_cls, log_loss_radius, gnc_control_val,
                 flatten_dims: bool = False, name=None):
        if not getattr(loss_cls, "is_gnc", False):
            raise ValueError(f"{loss_cls.__name__} is not a GNC-capable loss.")
        super().__init__(cost_function, loss_cls, log_loss_radius, flatten_dims=flatten_dims, name=name)
        self.gnc_control_val = _as_batched_scalar(gnc_control_val)
        self.aux_vars = tuple(self.aux_vars) + (self.gnc_control_val,)

    def schema(self):
        return ("GNC",) + super().schema()
