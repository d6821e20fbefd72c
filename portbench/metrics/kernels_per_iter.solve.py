"""Device kernels (memory copies and sets left out) in the profiled window
of a solve cell, over the LM iterations in it (calls times the
configuration's iteration count: the solve cells run a fixed count)."""

from portbench.trace_reduce import is_kernel


def read(ctx):
    if ctx.kind != "solve" or not ctx.iterations:
        return None
    return sum(1 for s in ctx.dev if is_kernel(s.name)) / ctx.iterations
