"""The block assembly's share of its roofline: one assembly of AtA and Atb
per LM iteration in the profiled window (counts/kernels.py `assemble`)
over the device time of the assembly kernel."""

from portbench.counts import kernels, peaks
from portbench.trace_reduce import device_seconds

NAMES = ("assemble_kernel",)


def read(ctx):
    if ctx.kind != "solve" or not ctx.iterations:
        return None
    seconds, launches = device_seconds(ctx.dev, NAMES)
    if not launches:
        return None
    return 100.0 * ctx.iterations * peaks.least_seconds(*kernels.assemble(ctx.shapes, ctx.itemsize)) / seconds
