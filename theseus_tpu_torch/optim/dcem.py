"""DCEM: the differentiable cross-entropy-method optimizer (JAX counterpart: theseus_tpu/optim/dcem.py).

Each iteration draws n_sample Gaussians around the current mean in RAW
variable coordinates (`CompiledObjective.flatten_raw`), evaluates the
objective for every sample, selects an elite set (soft by the LML layer,
a softmax when n_elite is 1, or a hard top-k when `temp=None`) and moves
the mean and sigma to the elite's weighted moments.

The samples are folded into the batch axis (sample-major, batch s * B + b,
with the aux repeated by `CompiledObjective.repeat_aux`): one error-metric
call for all of them, where the JAX package vmaps over the sample axis.
The noise comes from a `torch.Generator` through `_draw_noise`, the only
place that draws: the JAX package splits a key once an iteration. Without a
generator each solve starts from a fresh one seeded 0 on the state's
device (each solve the same draws, as the JAX package's default key); a
generator that is passed is consumed as it is.

DCEM runs on the optimizers' carry protocol (init_carry / iteration /
run_scan / run_while), so `TheseusLayer(DCEM(obj))` differentiates in the
unroll and truncated modes; implicit and dlm need a linearization and the
layer rejects them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..lie.utils import draw
from .lml import lml
from .nonlinear import NLSOptions, NonlinearLeastSquares


@dataclasses.dataclass(frozen=True)
class DCEMOptions(NLSOptions):
    max_iterations: int = 50
    abs_err_tolerance: float = 1e-6
    rel_err_tolerance: float = 1e-4
    n_sample: int = 100
    n_elite: int = 5
    temp: Optional[float] = 1.0  # None -> hard top-k elite selection
    init_sigma: float = 1.0
    lml_eps: float = 1e-3
    normalize: bool = True


class DCEM(NonlinearLeastSquares):
    method = "dcem"
    supported_modes = ("unroll", "truncated")

    def __init__(self, objective, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(objective, end_iter_callback=kwargs.pop("end_iter_callback", None))
        self.generator = generator
        self.opts = DCEMOptions(**kwargs)

    def _init_scalar_state(self, opts) -> float:
        return 0.0  # no damping or trust-region state

    # -- carry protocol --------------------------------------------------
    def init_carry(self, state, aux, opts: DCEMOptions, batch_ignore_mask=None, generator=None):
        carry = super().init_carry(state, aux, opts, batch_ignore_mask)
        mu = self.compiled.flatten_raw(state)
        carry["mu"] = mu
        carry["sigma"] = torch.full_like(mu, opts.init_sigma)
        gen = generator if generator is not None else self.generator
        if gen is None:
            gen = torch.Generator(device=mu.device)
            gen.manual_seed(0)
        carry["generator"] = gen
        return carry

    def _draw_noise(self, generator, shape, dtype, device):
        """Standard normal noise (S, B, R), drawn on the generator's device."""
        return draw(True, shape, generator, dtype, device)

    def _elite_weights(self, nfx, opts: DCEMOptions):
        """(B, S) costs -> (B, S) elite weights summing to n_elite."""
        if opts.temp is None:
            # hard top-k indicator: the selection has no gradient, the
            # values it selects keep theirs
            idx = torch.topk(-nfx, opts.n_elite, dim=1).indices
            return torch.zeros_like(nfx).scatter_(1, idx, 1.0)
        if opts.n_elite == 1:
            return torch.softmax(-nfx * opts.temp, dim=1)
        return lml(-nfx * opts.temp, opts.n_elite)

    def _cem_step(self, co, mu, sigma, aux, noise, opts: DCEMOptions):
        """One CEM update from the noise (S, B, R): (new_mu, new_sigma)."""
        s, (b, r) = noise.shape[0], mu.shape
        xs = mu[None] + sigma[None] * noise  # (S, B, R)
        fx = co.error_metric(co.unflatten_raw(xs.reshape(s * b, r)), co.repeat_aux(aux, s))
        fx = fx.reshape(s, b).transpose(0, 1)  # (B, S)
        if opts.normalize:
            fmu = torch.mean(fx, dim=1, keepdim=True)
            fsig = torch.std(fx, dim=1, keepdim=True, correction=0)
            nfx = (fx - fmu) / (fsig + 1e-6)
        else:
            nfx = fx
        w = self._elite_weights(nfx, opts)[..., None]  # (B, S, 1)
        xs_b = xs.transpose(0, 1)  # (B, S, R)
        new_mu = torch.sum(w * xs_b, dim=1) / opts.n_elite
        new_sigma = torch.sqrt(torch.sum(w * (xs_b - new_mu[:, None]) ** 2, dim=1) / opts.n_elite)
        return new_mu, new_sigma

    def iteration(self, carry, aux, opts: DCEMOptions):
        co = self.compiled
        mu, sigma = carry["mu"], carry["sigma"]
        noise = self._draw_noise(carry["generator"], (opts.n_sample,) + tuple(mu.shape), mu.dtype, mu.device)
        new_mu, new_sigma = self._cem_step(co, mu, sigma, aux, noise, opts)
        new_err = co.error_metric(co.unflatten_raw(new_mu), aux)

        bad = ~torch.isfinite(new_err)
        do_update = ~carry["done"] & ~bad
        mu = torch.where(do_update[:, None], new_mu, mu)
        sigma = torch.where(do_update[:, None], new_sigma, sigma)
        err = torch.where(do_update, new_err, carry["err"])

        change = carry["err"] - err
        denom = torch.where(carry["err"] == 0, torch.ones_like(err), carry["err"])
        conv = (torch.abs(change) < opts.abs_err_tolerance) | (torch.abs(change / denom) < opts.rel_err_tolerance)
        newly_converged = conv & do_update
        it = carry["it"] + 1
        converged_iter = torch.where(
            newly_converged & (carry["converged_iter"] < 0) & ~carry["done"],
            torch.full_like(carry["converged_iter"], it),
            carry["converged_iter"],
        )
        state = co.unflatten_raw(mu)
        out = {
            "state": state,
            "mu": mu,
            "sigma": sigma,
            "generator": carry["generator"],
            "err": err,
            "done": carry["done"] | newly_converged,
            "ignore": carry["ignore"],
            "fail": carry["fail"] | (bad & ~carry["done"]),
            "damping": carry["damping"],
            "it": it,
            "converged_iter": converged_iter,
            "best_err": torch.minimum(carry["best_err"], err),
        }
        if "history" in carry:
            hist = carry["history"]
            if it < hist.shape[0]:
                hist = hist.clone()
                hist[it] = err
            out["history"] = hist
        if "state_history" in carry:
            shist = carry["state_history"]
            if it < opts.max_iterations + 1:
                shist = {tk: h.clone() for tk, h in shist.items()}
                for tk, h in shist.items():
                    h[it] = state[tk]
            out["state_history"] = shist
        return out

    # -- standalone API ----------------------------------------------------
    def solve(self, state, aux, generator=None, opts: Optional[DCEMOptions] = None, batch_ignore_mask=None):
        """max_iterations masked iterations; returns the final carry."""
        opts = opts or self.opts
        carry = self.init_carry(state, aux, opts, batch_ignore_mask, generator=generator)
        return self.run_scan(carry, aux, opts.max_iterations, opts)

    def optimize(self, values=None, input_tensors=None, generator=None, **kwargs):
        """One solve of max_iterations masked iterations without gradients
        (the JAX package's jitted scan): returns (values, info)."""
        co = self.compiled
        values = values or self.objective.default_values(input_tensors)
        b = co.resolve_batch_size(values)
        state = co.pack(values, b)
        aux = co.build_aux(values, b)
        opts = dataclasses.replace(self.opts, **kwargs) if kwargs else self.opts
        with torch.no_grad():
            carry = self.solve(state, aux, generator, opts)
        info = self.make_info(carry, opts)
        out = dict(values)
        out.update(co.unpack(carry["state"]))
        return out, info
