"""Timing and profiling helpers (JAX counterpart: theseus_tpu/utils/timer.py).

`Timer` is a scoped timer with per-name stats; with `sync` it waits for
the card before reading the clock at both ends, so wall times include the
queued device work. `device_sync` is `torch.cuda.synchronize` on a CUDA
device and nothing on the CPU. `Profiler` wraps cProfile. `fresh_eps`
gives a small perturbation that differs in every call, so that two timed
calls never run on bit-identical inputs.
"""

from __future__ import annotations

import cProfile
import pstats
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


def device_sync(device=None) -> None:
    """Wait for all queued work on `device` (default: the current CUDA
    device when a card is present); a no-op on the CPU."""
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Scoped timer with per-name stats: `with timer("name"):` or
    `timer.start("name") ... timer.end()`."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.stats: Dict[str, list] = defaultdict(list)
        self._name: Optional[str] = None

    def _sync(self):
        if self.sync:
            device_sync()

    def start(self, name: str):
        self._name = name
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def end(self) -> float:
        self._sync()
        elapsed = time.perf_counter() - self._t0
        self.stats[self._name].append(elapsed)
        return elapsed

    def __call__(self, name: str):
        self._name = name
        return self

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"mean": float(np.mean(v)), "min": float(np.min(v)), "max": float(np.max(v)), "count": len(v)}
            for k, v in self.stats.items()
        }


class Profiler:
    """cProfile wrapper."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._prof = cProfile.Profile()

    def enable(self):
        if self.enabled:
            self._prof.enable()

    def disable(self):
        if self.enabled:
            self._prof.disable()

    def print(self, sort: str = "cumtime", limit: int = 30):
        if self.enabled:
            pstats.Stats(self._prof).sort_stats(sort).print_stats(limit)

    def dump(self, path: str):
        if self.enabled:
            self._prof.dump_stats(path)


def fresh_eps(i: int, scale: float = 1e-7) -> float:
    """scale * (i + 1 + salt), the salt in (0, 1) taken from the clock: a
    perturbation of size O(scale) that is unique across calls and
    processes, so that no timed call repeats an earlier call's inputs bit
    for bit."""
    salt = (time.time_ns() % 999_983) / 999_983.0
    return scale * (i + 1 + salt)
