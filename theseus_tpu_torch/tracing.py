"""Spans of the program's layers, recorded only while torch.profiler records.

`with span("tt.factor"): ...` marks an interval of the host's work. With
no profiler running, `span` returns one shared no-op context manager: a
flag read and an empty `with`, under a microsecond a span (PERF.md gives
the measured cost). Under `torch.profiler.profile`
it returns `torch._C._profiler._RecordFunctionFast(name)`, so the span is an
event of the profiler's own trace, on the same clock as the kernels and
the aten operations, and its nesting tells which call and which iteration
it belongs to. The event is function-scoped, as an aten operation is, and
not a user annotation (`record_function`), which Kineto would also turn
into a device-side `gpu_user_annotation` event: a span adds nothing to the
device side of a trace.

The names carry the `tt.` prefix; `SPANS` lists every one the program
emits. Nothing is counted or exported here: the profiler keeps the events
and whoever runs it reads them.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

SPANS = (
    "tt.forward",  # layer.py TheseusLayer.forward, the whole call
    "tt.pack",  # layer.py: default values, compile, pack, aux
    "tt.unpack",  # layer.py: the info and the output values
    "tt.lm.init",  # optim/nonlinear.py init_carry
    "tt.lm.iteration",  # optim/nonlinear.py iteration
    "tt.lm.sync",  # optim/nonlinear.py run_while's host sync
    "tt.linearize",  # optim/normal.py build: residuals and jacobians
    "tt.assemble",  # optim/normal.py build: the normal equations
    "tt.solve",  # optim/nonlinear.py iteration: damping and the linear solve
    "tt.factor",  # sparse/cholesky.py factorize
    "tt.subst",  # sparse/cholesky.py solve_with_factor, _refine_with_factor
    "tt.schur.eliminate",  # optim/schur.py: the landmark Choleskys and W
    "tt.schur.reduce",  # optim/schur.py: Hcc and the pair sum into S
    "tt.schur.factor",  # optim/schur.py: the Cholesky of S
    "tt.schur.backsub",  # optim/schur.py: each apply of the factors
    "tt.implicit_step",  # layer.py _implicit_final_step
    "tt.backward.solve",  # sparse/cholesky.py _SparseBlockSolve.backward
    "tt.backward.assemble",  # sparse/assemble_kernel.py _AssembleBlocks.backward
    "tt.backward.vjp",  # ops/twin_vjp.py _TwinVJP.backward
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a span of the running
    profiler's trace, or does nothing when no profiler runs."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF
