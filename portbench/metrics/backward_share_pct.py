"""Share of a training step spent after the loss: backward() and the
optimizer step, on the host clock, with a device synchronisation at the
boundary (the profiled steps of a traced run only)."""


def read(ctx):
    if ctx.kind != "train" or not ctx.marks:
        return None
    fwd = sum(m[0] for m in ctx.marks)
    bwd = sum(m[1] for m in ctx.marks)
    return 100.0 * bwd / (fwd + bwd)
