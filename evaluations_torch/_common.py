"""Shared pieces of the evaluation scripts: the device, the marginal timing window, the card line and the results writer.

- `device_of(name)`: the device a script runs on: the card unless the
  caller names one (`--device cpu`); without a card the default raises.
  On the card it builds the kernels first, outside any timed call.
- `marginal_ms(solve, base, extra)`: ms per iteration as
  (t(base + extra) - t(base)) / extra, each call timed from a sync of the
  device to the next, on inputs salted by `fresh_eps` so that no timed call
  repeats another's inputs bit for bit.
- `or_out_of_memory(fn, label)`: runs one cell; a cell that runs out of
  device memory is recorded as failed, any other error raises.
- `card_line(device)`: what `nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader` prints for a CUDA device; the processor for the
  CPU. Every results file carries it in its header.
- `write_results(path, title, sections, ...)`: writes the markdown tables
  of a script, merged into what the file already holds: a section of the
  same heading is replaced, and with `n_key` its rows are merged by their
  first `n_key` cells (a run at one size keeps the rows of another).
"""

from __future__ import annotations

import dataclasses
import pathlib
import platform
import subprocess
import time
from typing import Callable, List, Optional, Sequence

import torch

from theseus_tpu_torch import config
from theseus_tpu_torch.utils.timer import device_sync, fresh_eps

__all__ = ["Section", "card_line", "device_of", "fresh_eps", "marginal_ms", "or_out_of_memory", "synced_s",
           "write_results"]


def device_of(name: Optional[str]) -> torch.device:
    """`name` as a device; None is the card (`config.default_device`, which
    raises without one). On a card, the CUDA kernels and the native
    symbolic analysis are built here, before anything is timed, and the
    seconds are printed: a first call then times the solve, not nvcc."""
    dev = config.resolve_device(name)
    if dev.type == "cuda":
        from theseus_tpu_torch import _cuda, native

        t0 = time.perf_counter()
        _cuda.lib()
        native.lib()
        print(f"kernels and native symbolic analysis ready in {time.perf_counter() - t0:.1f} s")
    return dev


def or_out_of_memory(fn: Callable, label: str):
    """(fn(), None), or (None, "failed (OutOfMemoryError)") when the card runs
    out of memory: the cell is recorded as failed and the next one runs on
    a freed cache. Any other error raises."""
    try:
        return fn(), None
    except torch.cuda.OutOfMemoryError as e:
        print(f"{label}: FAILED {type(e).__name__}: {e}", flush=True)
    torch.cuda.empty_cache()  # the failed call's tensors are released with the exception
    return None, "failed (OutOfMemoryError)"


def synced_s(fn: Callable, device) -> tuple:
    """(fn(), seconds from a sync of `device` before the call to one after)."""
    device_sync(device)
    t0 = time.perf_counter()
    out = fn()
    device_sync(device)
    return out, time.perf_counter() - t0


def marginal_ms(solve: Callable, base: int, extra: int, device, reps: int = 3) -> float:
    """Marginal ms per iteration, (t(base + extra) - t(base)) / extra, the
    minimum over `reps` calls of each length. `solve(n, eps)` runs n
    iterations from inputs scaled by 1 + eps and returns a tensor that
    depends on all of them; eps is a fresh salt every call. Warm up first."""

    def run(n, i):
        out, s = synced_s(lambda: solve(n, fresh_eps(i)), device)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError(f"timed solve of {n} iterations gave a non-finite result")
        return s

    t_base = min(run(base, i) for i in range(reps))
    t_long = min(run(base + extra, reps + i) for i in range(reps))
    return (t_long - t_base) / extra * 1e3


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the card
    of `device`), or the host's processor for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"CPU ({platform.processor() or platform.machine()}), no card"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[device.index or 0] if len(lines) > (device.index or 0) else lines[0]


@dataclasses.dataclass
class Section:
    """One table: `## heading`, the notes under it, the header row and the
    rows (lists of cell strings). n_key > 0 merges the rows with those of a
    section of the same heading already in the file, by their first n_key
    cells; 0 replaces them."""

    heading: str
    notes: str
    columns: Sequence[str]
    rows: List[Sequence[str]]
    n_key: int = 0


def _cells(line: str) -> List[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _read(path: pathlib.Path):
    """(card lines, {heading: (notes, columns, rows)} in file order)."""
    cards, sections, heading = [], {}, None
    for line in path.read_text().splitlines():
        if line.startswith("Card: "):
            cards.append(line[len("Card: "):].strip())
        elif line.startswith("## "):
            heading = line[3:].strip()
            sections[heading] = ([], None, [])
        elif heading is not None:
            notes, cols, rows = sections[heading]
            if line.startswith("|"):
                if cols is None:
                    sections[heading] = (notes, _cells(line), rows)
                elif not set(line.replace("|", "").strip()) <= {"-", " "}:
                    rows.append(_cells(line))
            elif cols is None:
                notes.append(line)
    return cards, {h: ("\n".join(n).strip(), c or [], r) for h, (n, c, r) in sections.items()}


def write_results(path, title: str, sections: Sequence[Section], card: str, preamble: str = "",
                  fresh: bool = False, sort_key: Optional[Callable] = None) -> pathlib.Path:
    """Write `sections` into the markdown file `path`, under `title`, the
    `preamble` and one `Card: ...` line for each card whose runs the file
    holds. Unless `fresh`, the sections of other headings already in the
    file stay, in their order. `sort_key(row)` orders merged rows."""
    path = pathlib.Path(path)
    cards, old = ([], {}) if fresh or not path.exists() else _read(path)
    if card not in cards:
        cards.append(card)
    merged = dict(old)
    for s in sections:
        rows = [list(r) for r in s.rows]
        prev = old.get(s.heading)
        if s.n_key and prev is not None and list(prev[1]) == list(s.columns):
            keep = {tuple(r[: s.n_key]): r for r in prev[2]}
            keep.update({tuple(r[: s.n_key]): r for r in rows})
            rows = list(keep.values())
            if sort_key is not None:
                rows.sort(key=sort_key)
        merged[s.heading] = (s.notes.strip(), list(s.columns), rows)
    out = [f"# {title}", ""]
    if preamble:
        out += [preamble.strip(), ""]
    out += [f"Card: {c}" for c in cards] + [""]
    for heading, (notes, cols, rows) in merged.items():
        out += [f"## {heading}", ""]
        if notes:
            out += [notes, ""]
        out += ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
        out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows] + [""]
    path.write_text("\n".join(out))
    print(f"wrote {path}")
    return path
