"""Reduction of a torch.profiler trace to what the per-layer metrics and
the result's breakdown read: the device operations, the union of their
intervals (the busy time), and the idle gaps between them named by what the
host was doing meanwhile.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, NamedTuple, Sequence, Tuple


class Span(NamedTuple):
    name: str
    start: float  # microseconds on the profiler's clock
    end: float


def split_events(prof) -> Tuple[List[Span], List[Span]]:
    """(device operations, host operations) of a finished profile."""
    import torch

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        span = Span(e.name, float(tr.start), float(tr.end))
        (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(span)
    return dev, host


def merged(spans: Sequence[Span]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return [(a, b) for a, b in out]


def busy_seconds(dev: Sequence[Span]) -> float:
    return sum(b - a for a, b in merged(dev)) * 1e-6


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def top_device_ops(dev: Sequence[Span], n: int = 10):
    total = defaultdict(float)
    for s in dev:
        total[s.name] += (s.end - s.start) * 1e-6
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


def idle_gaps(dev: Sequence[Span], host: Sequence[Span], n: int = 10):
    """The device's idle time inside the host's span, summed by the name of
    the innermost host operation running at each gap's middle ("no host
    operation" where none ran), the largest first."""
    if not host:
        return []
    lo = min(s.start for s in host)
    hi = max(s.end for s in host)
    busy = [(a, b) for a, b in merged(dev) if b > lo and a < hi]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    hs = sorted(host, key=lambda s: s.start)
    starts = [s.start for s in hs]
    total = defaultdict(float)
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b <= a:
            continue
        mid, name = 0.5 * (a + b), "no host operation"
        i = bisect.bisect_right(starts, mid) - 1
        # nested operations start later than the ones around them: the
        # latest start that still covers the middle is the innermost
        for j in range(i, max(i - 512, -1), -1):
            if hs[j].end > mid:
                name = hs[j].name
                break
        total[name] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


def device_seconds(dev: Sequence[Span], names: Sequence[str]) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds any
    of `names`."""
    hit = [s for s in dev if any(k in s.name for k in names)]
    return sum(s.end - s.start for s in hit) * 1e-6, len(hit)
