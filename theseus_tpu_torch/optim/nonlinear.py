"""Batched second-order optimizers: Gauss-Newton, Levenberg-Marquardt, Dogleg and the linear solve (JAX counterpart: theseus_tpu/optim/nonlinear.py).

All per-batch-element logic (convergence, LM accept/reject, the Dogleg
trust radius, freezing of finished or failed elements) is expressed as
masks over the batch, as in the JAX package. `run_scan` is a fixed-length Python loop that never reads a
device value back to the host, so a solve on the card is one stream of
launches; `run_while` checks after every iteration whether all elements are
done (one host sync per iteration) and stops early.

Three linearizations, each differentiable end to end (the layer's backward
modes): "dense" (the default, as in the JAX package: the dense jacobian,
AtA by one batched product and a batched Cholesky, optim/linear.py), "sparse"
(the block Cholesky with the CUDA kernels) and "schur" (landmark
elimination, optim/schur.py).

Per-iteration bookkeeping, as in the JAX package: the error history (on by
default), the state history (`track_state_history`: every type stack at
every iteration, NaN past the last one run), `verbose` (prints the mean
error each iteration: one value read back to the host, only when asked
for) and `end_iter_callback`, called as `cb(optimizer, err (B,),
delta (B, D), iteration)` with the device tensors, adding no host sync of
its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..core.compiled import CompiledObjective
from ..tracing import span
from .linear import DenseCholeskySolver, damping_diag
from .normal import DenseNormalBuilder, SparseNormalBuilder


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
    state_history: Optional[Dict[str, Any]] = None  # {type: (max_iter+1, N_t, B, *shape)}


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
    # Read by no builder, as in the JAX package: the builders keep their own
    # 1e-8; a dense solve takes another through
    # `linear_solver=DenseCholeskySolver(damping_eps=...)`.
    damping_eps: float = 1e-8
    down_damping_ratio: float = 9.0
    up_damping_ratio: float = 11.0
    damping_accept: float = 0.1
    min_damping: float = 1e-7
    max_damping: float = 1e7
    track_err_history: bool = True
    track_state_history: bool = False
    verbose: bool = False
    # trust-region options (Dogleg)
    trust_region_init: float = 0.5
    accept_threshold: float = 0.0
    shrink_threshold: float = 0.25
    expand_threshold: float = 0.75
    shrink_ratio: float = 0.25
    expand_ratio: float = 2.0
    min_trust_region: float = 1e-5
    max_trust_region: float = 1e5


class NonlinearLeastSquares:
    """Base for GN/LM/Dogleg. Holds the objective and exposes `init_carry`,
    `iteration` and `run_*` building blocks that the layer composes."""

    method = "base"
    # backward modes usable through TheseusLayer
    supported_modes = ("unroll", "implicit", "truncated", "dlm")

    def __init__(
        self,
        objective,
        linear_solver=None,
        linearization: str = "dense",
        ordering="auto",
        max_iterations: int = 20,
        step_size: float = 1.0,
        abs_err_tolerance: float = 1e-10,
        rel_err_tolerance: float = 1e-8,
        **opt_kwargs,
    ):
        if linearization not in ("dense", "sparse", "schur"):
            raise ValueError("linearization must be 'dense', 'sparse' or 'schur'")
        self.objective = objective
        # the dense linearization's solver (optim/linear.py)
        self.linear_solver = linear_solver
        self.linearization = linearization
        self.ordering = ordering
        # schur: predicate(name, group) -> True for the variables to eliminate
        # (default optim.schur.eliminate_points: every Euclidean variable)
        self.eliminate = opt_kwargs.pop("eliminate", None)
        # the sparse linearization's solve: "direct" (block Cholesky) or
        # "pcg" (block-Jacobi PCG, sparse/pcg.py, pcg_iters iterations)
        self.sparse_solver = opt_kwargs.pop("sparse_solver", "direct")
        self.pcg_iters = opt_kwargs.pop("pcg_iters", 100)
        # called as cb(optimizer, err (B,), delta (B, D), iteration)
        self.end_iter_callback = opt_kwargs.pop("end_iter_callback", None)
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
    def normal_builder(self):
        co = self.compiled
        if self._normal_builder is None or self._normal_builder.co is not co:
            if self.linearization == "dense":
                self._normal_builder = DenseNormalBuilder(co, self.linear_solver or DenseCholeskySolver())
            elif self.linearization == "schur":
                from .schur import SchurNormalBuilder, eliminate_points

                self._normal_builder = SchurNormalBuilder(co, self.eliminate or eliminate_points)
            else:
                self._normal_builder = SparseNormalBuilder(co, ordering=self.ordering, solver=self.sparse_solver,
                                                           pcg_iters=self.pcg_iters)
        return self._normal_builder

    def _init_scalar_state(self, opts: NLSOptions) -> float:
        return opts.damping

    # -- pure building blocks -------------------------------------------
    def init_carry(self, state, aux, opts: NLSOptions, batch_ignore_mask=None) -> Dict:
        """batch_ignore_mask: optional (B,) bool; True freezes that batch
        element for the whole solve."""
        with span("tt.lm.init"):
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
            if opts.track_state_history:
                shist = {}
                for tk, s in state.items():
                    h = torch.full((opts.max_iterations + 1,) + tuple(s.shape), float("nan"), dtype=s.dtype,
                                   device=s.device)
                    h[0] = s
                    shist[tk] = h
                carry["state_history"] = shist
            return carry

    def compute_delta(self, ns, damping, opts: NLSOptions):
        """Subclass hook: returns (delta, fail_mask) from a normal system."""
        raise NotImplementedError

    def _accept_and_damping(self, delta, ns, new_err, prev_err, damping, opts):
        """Subclass hook: returns (accept_mask (B,), new_damping)."""
        return torch.ones_like(new_err, dtype=torch.bool), damping

    def iteration(self, carry, aux, opts: NLSOptions):
        with span("tt.lm.iteration"):
            co = self.compiled
            state = carry["state"]
            ns = self.normal_builder.build(state, aux)
            with span("tt.solve"):
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
            if opts.verbose:
                print(f"Nonlinear optimizer. Iteration: {it}. Error: {float(torch.mean(err))}")
            if self.end_iter_callback is not None:
                self.end_iter_callback(self, err, delta, it)
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
            if "state_history" in carry:
                shist = carry["state_history"]
                if it < opts.max_iterations + 1:
                    shist = {tk: h.clone() for tk, h in shist.items()}
                    for tk, h in shist.items():
                        h[it] = new_state[tk]
                out["state_history"] = shist
            return out

    def run_scan(self, carry, aux, num_iters: int, opts: NLSOptions):
        """Fixed-length loop (masked; no early exit, no host sync)."""
        for _ in range(max(num_iters, 0)):
            carry = self.iteration(carry, aux, opts)
        return carry

    def run_while(self, carry, aux, max_iters: int, opts: NLSOptions):
        """Early-exit loop: stops once every element is done or failed."""
        for _ in range(max(max_iters, 0)):
            with span("tt.lm.sync"):
                finished = bool(torch.all(carry["done"] | carry["fail"]))
            if finished:
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
            state_history=carry.get("state_history"),
        )

    # -- user-facing solve (no outer-gradient bookkeeping; see layer.py) --
    def optimize(self, values=None, input_tensors=None, verbose: bool = False,
                 batch_ignore_mask=None, **kwargs):
        """One early-exit solve without gradients: returns (values, info).
        kwargs override the optimizer's NLSOptions for this call. The normal
        builder (block pattern, symbolic analysis, schedule) is kept on the
        optimizer, so a second call on the same objective does not redo it."""
        co = self.compiled
        values = values or self.objective.default_values(input_tensors)
        bsz = co.resolve_batch_size(values)
        state = co.pack(values, bsz)
        aux = co.build_aux(values, bsz)
        if verbose:
            kwargs["verbose"] = True
        opts = dataclasses.replace(self.opts, **kwargs) if kwargs else self.opts
        with torch.no_grad():
            carry = self.init_carry(state, aux, opts, batch_ignore_mask)
            carry = self.run_while(carry, aux, opts.max_iterations, opts)
        info = self.make_info(carry, opts)
        out = dict(values)
        out.update(co.unpack(carry["state"]))
        return out, info


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


class Dogleg(NonlinearLeastSquares):
    """Dogleg trust-region steps. The per-batch scalar state carried across
    iterations is the trust radius. Everything comes from the normal
    system's solve, Atb and quadratic form (||A d||^2 = d^T AtA d), so the
    same code serves the dense, sparse and Schur linearizations."""

    method = "dogleg"
    EPS = 1e-7

    def _init_scalar_state(self, opts: NLSOptions) -> float:
        return opts.trust_region_init

    def compute_delta(self, ns, trust_region, opts: NLSOptions):
        delta_gn, fail = ns.solve(0.0, False)
        tr2 = (trust_region ** 2)[:, None]

        delta_sd = ns.Atb  # steepest descent (the gradient is -Atb)
        sd_ata_sd = ns.quad(delta_sd)[:, None]
        grad_norm_2 = torch.sum(delta_sd ** 2, dim=-1, keepdim=True)
        cauchy_step = grad_norm_2 / (sd_ata_sd + Dogleg.EPS)
        delta_c = delta_sd * cauchy_step
        delta_c_norm_2 = grad_norm_2 * cauchy_step ** 2
        c_within = delta_c_norm_2 <= tr2

        # the Cauchy step truncated to the region
        delta_trunc = delta_c * trust_region[:, None] / torch.sqrt(delta_c_norm_2 + Dogleg.EPS)

        # along the dogleg path toward GN: ||c + tau (gn - c)|| = tr
        diff = delta_gn - delta_c
        a = torch.sum(diff ** 2, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(delta_c * diff, dim=-1, keepdim=True)
        c = delta_c_norm_2 - tr2
        # torch.maximum / minimum: half the gradient at a tie, as jnp's
        disc = torch.maximum(b ** 2 - 4.0 * a * c, a.new_tensor(Dogleg.EPS))
        tau = torch.minimum((-b + torch.sqrt(disc)) / (2.0 * a + Dogleg.EPS), a.new_tensor(1.0))
        delta_interp = delta_c + tau * diff

        gn_within = torch.sum(delta_gn ** 2, dim=-1, keepdim=True) < tr2
        delta = torch.where(gn_within, delta_gn, torch.where(c_within, delta_interp, delta_trunc))
        return delta, fail

    def _accept_and_damping(self, delta, ns, new_err, prev_err, trust_region, opts):
        # rho = actual / predicted reduction
        pred_err = prev_err - torch.sum(delta * ns.Atb, dim=-1) + 0.5 * ns.quad(delta)
        den = prev_err - pred_err
        den = torch.where(den == 0, torch.full_like(den, 1e-12), den)
        rho = (prev_err - new_err) / den
        tr = torch.where(rho < opts.shrink_threshold, trust_region * opts.shrink_ratio, trust_region)
        tr = torch.where(rho > opts.expand_threshold, tr * opts.expand_ratio, tr)
        tr = torch.clamp(tr, opts.min_trust_region, opts.max_trust_region)
        return rho >= opts.accept_threshold, tr


class LinearOptimizer(NonlinearLeastSquares):
    """One linearize + solve + retract: for objectives that are exactly
    least squares."""

    method = "linear"

    def __init__(self, objective, **kwargs):
        kwargs.setdefault("max_iterations", 1)
        super().__init__(objective, **kwargs)

    def compute_delta(self, ns, damping, opts: NLSOptions):
        return ns.solve(0.0, False)
