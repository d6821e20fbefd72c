"""The sparse factorization's share of its roofline: the whole numeric
block Cholesky, head and dense tail (counts/kernels.py `factor`), once per
factor stage in the profiled window, over the device time of those stages.

A factor stage is read from the device's order of operations (the program
runs on one stream): every operation from the one after an assembly
(`assemble_kernel`) to the one before the next forward substitution
(`fwd_subst_kernel`, `whole_fwd_kernel`), where that run holds a factor
kernel (`level_factor_kernel`, `whole_factor_kernel`) or the tail's
library Cholesky (`potrf`). So it takes in the level plan's gathers and
scatters, the dense tail's external update (its gather, copy and GEMM),
its Cholesky, and the diagonal's damping before them (a few small
elementwise kernels)."""

from portbench.counts import kernels, peaks

START = ("assemble_kernel",)
END = ("fwd_subst_kernel", "whole_fwd_kernel")
FACTOR = ("level_factor_kernel", "whole_factor_kernel", "potrf")


def factor_stages(dev):
    """(seconds, stages) of the factor stages among the device operations
    `dev` (trace_reduce.Span)."""
    seconds, stages = 0.0, 0
    inside, run, hit = False, 0.0, False
    for s in sorted(dev, key=lambda s: s.start):
        if any(k in s.name for k in START):
            inside, run, hit = True, 0.0, False
        elif inside and any(k in s.name for k in END):
            if hit:
                seconds, stages = seconds + run, stages + 1
            inside = False
        elif inside:
            run += (s.end - s.start) * 1e-6
            hit = hit or any(k in s.name for k in FACTOR)
    return seconds, stages


def read(ctx):
    if ctx.kind != "solve" or "pairs" not in ctx.shapes:
        return None
    seconds, stages = factor_stages(ctx.dev)
    if not stages:
        return None
    return 100.0 * stages * peaks.least_seconds(*kernels.factor(ctx.shapes, ctx.itemsize)) / seconds
