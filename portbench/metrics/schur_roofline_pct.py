"""The Schur elimination and reduction's share of its roofline: the least
time of their useful work (counts/schur.py), once per stage in the
profiled window, over the device time of those stages.

A stage is read from the device's order of operations (the program runs
on one stream): every operation from the one after an assembly
(`assemble_kernel`) to the one before the next Cholesky of S: the
library's factor kernel, named `potrf` or, as cuSOLVER runs a single
3204-wide float32 factor on the H100, `getrf_wo_pivot`. So it takes in the
diagonal's damping (a few small elementwise kernels), the landmark
Choleskys, W, Hcc and the pair sum into S (the `tt.schur.eliminate` and
`tt.schur.reduce` spans), and S's symmetrization and its copy into the
factor's buffer (under 0.1 ms)."""

from portbench.counts import peaks, schur

START = ("assemble_kernel",)
END = ("potrf", "getrf")


def schur_stages(dev):
    """(seconds, stages) of the elimination-and-reduction stages among the
    device operations `dev` (trace_reduce.Span)."""
    seconds, stages = 0.0, 0
    inside, run = False, 0.0
    for s in sorted(dev, key=lambda s: s.start):
        if any(k in s.name for k in START):
            inside, run = True, 0.0
        elif inside and any(k in s.name for k in END):
            seconds, stages = seconds + run, stages + 1
            inside = False
        elif inside:
            run += (s.end - s.start) * 1e-6
    return seconds, stages


def read(ctx):
    if ctx.kind != "solve" or "pairs_useful" not in ctx.shapes:
        return None
    seconds, stages = schur_stages(ctx.dev)
    if not stages or seconds <= 0:
        return None
    return 100.0 * stages * peaks.least_seconds(*schur.reduction(ctx.shapes, ctx.itemsize)) / seconds
