"""The device's idle time split by the program's own spans.

theseus_tpu_torch records a span at each layer boundary while a profiler
runs (`theseus_tpu_torch/tracing.py`: host events named `tt.*`, on the
trace's clock). `idle_by_span` cuts the device's idle gaps at those spans'
boundaries and names each piece by the layer the host was in meanwhile;
`idle_pct` is what the `idle_<layer>_pct.<cell>` readers report, each
summing one entry of `LAYERS`. On a program without spans both return None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace_reduce import Span, merged

# the spans each `idle_<layer>_pct` reader sums; with "outside" they take
# every piece of idle time idle_by_span names
LAYERS = {
    "layer": ("tt.forward", "tt.pack", "tt.unpack", "tt.implicit_step"),
    "lm": ("tt.lm.init", "tt.lm.iteration", "tt.lm.sync", "tt.solve"),
    "linearize": ("tt.linearize",),
    "assemble": ("tt.assemble",),
    "factor": ("tt.factor",),
    "subst": ("tt.subst",),
    "backward": ("tt.backward.solve", "tt.backward.assemble", "tt.backward.vjp"),
}
# a span inside one of these counts whole: the sweeps of the solve's VJP
# are backward, not `tt.subst`
WHOLE = "tt.backward."


def idle_intervals(dev: Sequence[Span], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The complement of the device operations' union inside [lo, hi], as
    `trace_reduce.idle_gaps` takes it."""
    busy = [(a, b) for a, b in merged(dev) if b > lo and a < hi]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]


def innermost(spans: Sequence[Span]) -> List[Tuple[float, float, str]]:
    """[(start, end, name)] in time order: the stretches some span covers,
    each named by the innermost span covering it, the one with the latest
    start (of two that start together, the one that ends first)."""
    opens, closes = defaultdict(list), defaultdict(list)
    for i, s in enumerate(spans):
        if s.end > s.start:
            opens[s.start].append(i)
            closes[s.end].append(i)
    key = lambda i: (spans[i].start, -spans[i].end, i)  # noqa: E731
    points = sorted(set(opens) | set(closes))
    active, out = [], []  # active: keys in order, the innermost last
    for a, b in zip(points, points[1:]):
        for i in closes.get(a, ()):
            active.remove(key(i))
        for i in opens.get(a, ()):
            bisect.insort(active, key(i))
        if active:
            out.append((a, b, spans[active[-1][2]].name))
    return out


def _outside_whole(spans: Sequence[Span]) -> List[Span]:
    """`spans` less those nested inside a span named WHOLE* (other than
    such spans themselves)."""
    outer = merged([s for s in spans if s.name.startswith(WHOLE)])
    starts = [a for a, _ in outer]

    def nested(s):
        i = bisect.bisect_right(starts, s.start) - 1
        return i >= 0 and s.end <= outer[i][1]

    return [s for s in spans if s.name.startswith(WHOLE) or not nested(s)]


def idle_by_span(dev: Sequence[Span], host: Sequence[Span], prefix: str = "tt.") -> Optional[Dict[str, float]]:
    """Seconds of device idle time inside the host events' extent, by the
    innermost host span named `prefix`* covering each moment ("outside"
    where none does; a span nested in one named WHOLE* gives its time to
    that one); None when the host holds no such span. Each gap is split
    exactly at the spans' boundaries."""
    prog = [s for s in host if s.name.startswith(prefix)]
    if not prog:
        return None
    lo = min(s.start for s in host)
    hi = max(s.end for s in host)
    segs = innermost(_outside_whole(prog))
    total = defaultdict(float)
    k = 0
    for a, b in idle_intervals(dev, lo, hi):
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        t, j = a, k
        while t < b:
            if j < len(segs) and segs[j][0] < b:
                s0, s1, name = segs[j]
                if s0 > t:
                    total["outside"] += s0 - t
                    t = s0
                e = min(s1, b)
                total[name] += e - t
                t, j = e, j + 1
            else:
                total["outside"] += b - t
                t = b
    return {name: us * 1e-6 for name, us in total.items()}


def idle_pct(ctx, names: Sequence[str]) -> Optional[float]:
    """The idle seconds of spans `names` (idle_by_span) as a share, in %, of
    the profiled window `ctx.window_s`, the denominator of
    `device_idle_pct`. The shares of every span and "outside" add up to the
    idle time inside the host events' extent, so to at most
    `device_idle_pct`: the window, taken on the host's clock, may run past
    the first and the last host event. None without spans or a window."""
    if ctx.window_s <= 0:
        return None
    by = idle_by_span(ctx.dev, ctx.host)
    if by is None:
        return None
    return 100.0 * sum(by.get(n, 0.0) for n in names) / ctx.window_s


def reader(kind: str, layer: str):
    """The `read(ctx)` of `idle_<layer>_pct.<kind>`: the share of the
    window in which the device was idle while the host was in the spans of
    LAYERS[layer], in a cell of that kind."""

    def read(ctx):
        return idle_pct(ctx, LAYERS[layer]) if ctx.kind == kind else None

    return read
