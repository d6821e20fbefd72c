"""The SE3 Between kernel's share of its roofline: the least time of its
launches in the profiled window (counts/kernels.py `between`, every launch
linearizes the whole bucket) over their device time."""

from portbench.counts import kernels, peaks
from portbench.trace_reduce import device_seconds

NAMES = ("between_se3_kernel",)


def read(ctx):
    if "between" not in ctx.shapes:
        return None
    seconds, launches = device_seconds(ctx.dev, NAMES)
    if not launches:
        return None
    return 100.0 * launches * peaks.least_seconds(*kernels.between(ctx.shapes, ctx.itemsize)) / seconds
