"""Batched second-order optimizers: Gauss-Newton and Levenberg-Marquardt (JAX counterpart: theseus_tpu/optim/nonlinear.py).

All per-batch-element logic (convergence, LM accept/reject, freezing of
finished or failed elements) is expressed as masks over the batch, as in
the JAX package. `run_scan` is a fixed-length Python loop that never reads a
device value back to the host, so a solve on the card is one stream of
launches; `run_while` checks after every iteration whether all elements are
done (one host sync per iteration) and stops early.

Forward only: the layer refuses inputs that require grad. The sparse
linearization is the one ported; "dense" and "schur" raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from ..core.compiled import CompiledObjective
from .normal import SparseNormalBuilder


class NonlinearOptimizerStatus:
    START = 0
    CONVERGED = 1
    MAX_ITERATIONS = 2
    FAIL = -1


class OptimizerInfo(NamedTuple):
    """Per-batch-element solve diagnostics."""

    status: torch.Tensor  # (B,) int8
    converged_iter: torch.Tensor  # (B,) int32
    best_err: torch.Tensor  # (B,)
    last_err: torch.Tensor  # (B,)
    err_history: Optional[torch.Tensor] = None  # (max_iter+1, B)


@dataclasses.dataclass(frozen=True)
class NLSOptions:
    """Solve options."""

    max_iterations: int = 20
    step_size: float = 1.0
    abs_err_tolerance: float = 1e-10
    rel_err_tolerance: float = 1e-8
    damping: float = 0.001
    adaptive_damping: bool = False
    ellipsoidal_damping: bool = False
    damping_eps: float = 1e-8
    down_damping_ratio: float = 9.0
    up_damping_ratio: float = 11.0
    damping_accept: float = 0.1
    min_damping: float = 1e-7
    max_damping: float = 1e7
    track_err_history: bool = True


def damping_diag(ata_diag, damping, ellipsoidal: bool):
    """The per-column damping actually applied (for the LM gain-ratio
    denominator)."""
    d = torch.as_tensor(damping, dtype=ata_diag.dtype, device=ata_diag.device)
    if d.dim() == 0:
        d = d.expand(ata_diag.shape[:-1])
    if ellipsoidal:
        return d[..., None] * ata_diag
    return d[..., None].expand(ata_diag.shape)


class NonlinearLeastSquares:
    """Base for GN/LM. Holds the objective and exposes `init_carry`,
    `iteration` and `run_*` building blocks that the layer composes."""

    method = "base"

    def __init__(
        self,
        objective,
        linearization: str = "sparse",
        ordering="auto",
        max_iterations: int = 20,
        step_size: float = 1.0,
        abs_err_tolerance: float = 1e-10,
        rel_err_tolerance: float = 1e-8,
        **opt_kwargs,
    ):
        if linearization in ("dense", "schur"):
            raise NotImplementedError(
                f"linearization='{linearization}' is not ported yet (ROADMAP.md, queue 1); "
                "use 'sparse'"
            )
        if linearization != "sparse":
            raise ValueError("linearization must be 'dense', 'sparse' or 'schur'")
        self.objective = objective
        self.linearization = linearization
        self.ordering = ordering
        self._normal_builder = None
        self.opts = NLSOptions(
            max_iterations=max_iterations,
            step_size=step_size,
            abs_err_tolerance=abs_err_tolerance,
            rel_err_tolerance=rel_err_tolerance,
            **opt_kwargs,
        )

    @property
    def compiled(self) -> CompiledObjective:
        return self.objective.compile()

    @property
    def normal_builder(self) -> SparseNormalBuilder:
        co = self.compiled
        if self._normal_builder is None or self._normal_builder.co is not co:
            self._normal_builder = SparseNormalBuilder(
                co, ordering=self.ordering, damping_eps=self.opts.damping_eps
            )
        return self._normal_builder

    def _init_scalar_state(self, opts: NLSOptions) -> float:
        return opts.damping

    # -- pure building blocks -------------------------------------------
    def init_carry(self, state, aux, opts: NLSOptions, batch_ignore_mask=None) -> Dict:
        """batch_ignore_mask: optional (B,) bool; True freezes that batch
        element for the whole solve."""
        co = self.compiled
        b = co.batch_size(state)
        dtype = co.state_dtype(state)
        dev = next(iter(state.values())).device
        err = co.error_metric(state, aux)
        ignore = (
            torch.zeros((b,), dtype=torch.bool, device=dev)
            if batch_ignore_mask is None
            else torch.as_tensor(batch_ignore_mask, dtype=torch.bool, device=dev)
        )
        carry = {
            "state": state,
            "err": err,
            "done": ignore.clone(),  # frozen elements never update
            "ignore": ignore,
            "fail": torch.zeros((b,), dtype=torch.bool, device=dev),
            "damping": torch.full((b,), self._init_scalar_state(opts), dtype=dtype, device=dev),
            "it": 0,
            "converged_iter": torch.full((b,), -1, dtype=torch.int32, device=dev),
            "best_err": err,
        }
        if opts.track_err_history:
            hist = torch.full((opts.max_iterations + 1, b), float("nan"), dtype=dtype, device=dev)
            hist[0] = err
            carry["history"] = hist
        return carry

    def compute_delta(self, ns, damping, opts: NLSOptions):
        """Subclass hook: returns (delta, fail_mask) from a SparseNormal."""
        raise NotImplementedError

    def _accept_and_damping(self, delta, ns, new_err, prev_err, damping, opts):
        """Subclass hook: returns (accept_mask (B,), new_damping)."""
        return torch.ones_like(new_err, dtype=torch.bool), damping

    def iteration(self, carry, aux, opts: NLSOptions):
        co = self.compiled
        state = carry["state"]
        ns = self.normal_builder.build(state, aux)
        delta, solver_fail = self.compute_delta(ns, carry["damping"], opts)
        tentative = co.retract(state, opts.step_size * delta)
        new_err = co.error_metric(tentative, aux)

        accept, damping = self._accept_and_damping(
            delta, ns, new_err, carry["err"], carry["damping"], opts
        )
        bad = solver_fail | ~torch.isfinite(new_err)
        active = ~carry["done"] & ~bad
        do_update = accept & active

        new_state = {}
        for tk in state:
            m = do_update.reshape((1, -1) + (1,) * (state[tk].dim() - 2))
            new_state[tk] = torch.where(m, tentative[tk], state[tk])
        err = torch.where(do_update, new_err, carry["err"])

        # convergence; rejected steps do not count as converged
        all_small = torch.mean(torch.abs(err)) < opts.abs_err_tolerance
        change = carry["err"] - err
        denom = torch.where(carry["err"] == 0, torch.ones_like(err), carry["err"])
        conv = (torch.abs(change) < opts.abs_err_tolerance) | (
            torch.abs(change / denom) < opts.rel_err_tolerance
        )
        newly_converged = (conv & do_update) | all_small
        it = carry["it"] + 1
        converged_iter = torch.where(
            newly_converged & (carry["converged_iter"] < 0) & ~carry["done"],
            torch.full_like(carry["converged_iter"], it),
            carry["converged_iter"],
        )
        out = {
            "state": new_state,
            "err": err,
            "done": carry["done"] | newly_converged,
            "ignore": carry["ignore"],
            "fail": carry["fail"] | (bad & ~carry["done"]),
            "damping": damping,
            "it": it,
            "converged_iter": converged_iter,
            "best_err": torch.minimum(carry["best_err"], err),
        }
        if "history" in carry:
            hist = carry["history"]
            if it < hist.shape[0]:  # past max_iterations the JAX package drops the write
                hist = hist.clone()
                hist[it] = err
            out["history"] = hist
        return out

    def run_scan(self, carry, aux, num_iters: int, opts: NLSOptions):
        """Fixed-length loop (masked; no early exit, no host sync)."""
        for _ in range(max(num_iters, 0)):
            carry = self.iteration(carry, aux, opts)
        return carry

    def run_while(self, carry, aux, max_iters: int, opts: NLSOptions):
        """Early-exit loop: stops once every element is done or failed."""
        for _ in range(max(max_iters, 0)):
            if bool(torch.all(carry["done"] | carry["fail"])):
                break
            carry = self.iteration(carry, aux, opts)
        return carry

    def make_info(self, carry, opts: NLSOptions) -> OptimizerInfo:
        status = torch.where(
            carry["fail"],
            NonlinearOptimizerStatus.FAIL,
            torch.where(
                carry["done"],
                NonlinearOptimizerStatus.CONVERGED,
                NonlinearOptimizerStatus.MAX_ITERATIONS,
            ),
        ).to(torch.int8)
        status = torch.where(
            carry["ignore"], torch.full_like(status, NonlinearOptimizerStatus.START), status
        )
        return OptimizerInfo(
            status=status,
            converged_iter=carry["converged_iter"],
            best_err=carry["best_err"],
            last_err=carry["err"],
            err_history=carry.get("history"),
        )


class GaussNewton(NonlinearLeastSquares):
    """delta = solve(AtA, Atb)."""

    method = "gauss_newton"

    def compute_delta(self, ns, damping, opts: NLSOptions):
        return ns.solve(0.0, False)


class LevenbergMarquardt(NonlinearLeastSquares):
    """Damped steps with optional per-batch adaptive damping."""

    method = "levenberg_marquardt"

    def compute_delta(self, ns, damping, opts: NLSOptions):
        return ns.solve(damping, opts.ellipsoidal_damping)

    def _accept_and_damping(self, delta, ns, new_err, prev_err, damping, opts):
        if not opts.adaptive_damping:
            return torch.ones_like(new_err, dtype=torch.bool), damping
        # gain ratio rho = (prev - new) / (0.5 * delta . (damping*D*delta + Atb))
        dvec = damping_diag(ns.diag(), damping, opts.ellipsoidal_damping)
        den = 0.5 * torch.sum(delta * (dvec * delta + ns.Atb), dim=-1)
        den = torch.where(den == 0, torch.full_like(den, 1e-12), den)
        rho = (prev_err - new_err) / den
        reject = rho <= opts.damping_accept
        new_damping = torch.where(
            reject, damping * opts.up_damping_ratio, damping / opts.down_damping_ratio
        )
        new_damping = torch.clamp(new_damping, opts.min_damping, opts.max_damping)
        return ~reject, new_damping
