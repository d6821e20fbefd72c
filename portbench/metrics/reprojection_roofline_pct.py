"""The Reprojection kernel's share of its roofline, with the intrinsics
optimised: the least time of its launches in the profiled window
(counts/reprojection.py, every launch linearizes every observation) over
their device time."""

from portbench.counts import peaks, reprojection
from portbench.trace_reduce import device_seconds

NAMES = ("reprojection_intr_kernel",)


def read(ctx):
    if "n_obs" not in ctx.shapes:
        return None
    seconds, launches = device_seconds(ctx.dev, NAMES)
    if not launches:
        return None
    return 100.0 * launches * peaks.least_seconds(*reprojection.reprojection_intr(ctx.shapes, ctx.itemsize)) / seconds
