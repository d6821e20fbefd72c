"""Levenberg-Marquardt with per-element adaptive damping, in plain PyTorch.

The algorithm the configurations state (their "solver" settings): from x,
solve (H + damping D) d = g with g = -J^T e and D = I, or D = diag(H) for
ellipsoidal damping (then plus `eps` on the diagonal); accept x exp(d) where
the gain ratio (f(x) - f(x exp(d))) / (d . (damping D d + g) / 2) exceeds
`accept`, and divide the damping by `down`, else multiply it by `up`,
clamped to [min_damping, max_damping]; f = |e|^2 / 2. An element is frozen
once an accepted step changes f by less than `abs_tol`, or by less than
`rel_tol` of f. A step that fails (a non-finite step or cost) is dropped.

A problem supplies cost(x) -> (B,), normal(x) -> (g (B, D), diag (B, D),
system), solve(system, damping (B,), ellipsoidal) -> (d (B, D), bad (B,)),
retract(x, d) and select(mask (B,), x_if_true, x_if_false).
"""

from __future__ import annotations

import torch

DEFAULTS = dict(damping=1e-3, accept=0.1, up=11.0, down=9.0, min_damping=1e-7, max_damping=1e7,
                abs_tol=1e-10, rel_tol=1e-8, ellipsoidal=False, eps=1e-8)


def options(solver: dict) -> dict:
    """The LM settings of a configuration's "solver" entry, defaults filled."""
    opts = dict(DEFAULTS)
    opts.update({k: solver[k] for k in DEFAULTS if k in solver})
    return opts


def solve(problem, x, iterations: int, opts: dict):
    """`iterations` LM iterations from x. Returns (x, f (B,))."""
    f = problem.cost(x)
    b = f.shape[0]
    damping = torch.full((b,), float(opts["damping"]), dtype=f.dtype, device=f.device)
    done = torch.zeros((b,), dtype=torch.bool, device=f.device)
    for _ in range(iterations):
        g, diag, system = problem.normal(x)
        d, bad = problem.solve(system, damping, opts)
        xt = problem.retract(x, d)
        ft = problem.cost(xt)
        dvec = damping[:, None] * (diag if opts["ellipsoidal"] else torch.ones_like(diag))
        den = 0.5 * torch.sum(d * (dvec * d + g), dim=-1)
        den = torch.where(den == 0, torch.full_like(den, 1e-12), den)
        reject = (f - ft) / den <= opts["accept"]
        damping = torch.clamp(torch.where(reject, damping * opts["up"], damping / opts["down"]),
                              opts["min_damping"], opts["max_damping"])
        take = ~reject & ~done & ~bad & torch.isfinite(ft)
        x = problem.select(take, xt, x)
        f_new = torch.where(take, ft, f)
        change = f - f_new
        denom = torch.where(f == 0, torch.ones_like(f), f)
        conv = (torch.abs(change) < opts["abs_tol"]) | (torch.abs(change / denom) < opts["rel_tol"])
        done = done | (conv & take) | (torch.mean(torch.abs(f_new)) < opts["abs_tol"])
        f = f_new
    return x, f


def damp(h_diag, damping, opts):
    """The damped diagonal of H: h + damping, or h (1 + damping) + eps."""
    lam = damping[:, None]
    if opts["ellipsoidal"]:
        return h_diag * (1.0 + lam) + opts["eps"]
    return h_diag + lam
