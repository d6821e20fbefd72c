#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --what program,control,float32,half_batch,unchanged,altered

For each seed the problem is built as a run builds it, and each named
reading is taken on the calls a run would check:
- program: the program as the configuration states it (the lower reading);
- float64, float32, tf32, bfloat16: the plain reference put in the
  program's place, in that precision (reference/precision.py);
- control: the precision that limits/<cell>.json names as the cell's
  control (an upper reading);
- half_batch, unchanged, altered: the program with that fault of faults.py
  planted under its timed path.
Besides the numbers a run compares, each reading gives the signed mean and
the largest element of the batch's cost gaps. One JSON line per seed and
reading, on standard output and appended to chiprun_out/control_<cell>.jsonl.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_precision(cell) -> str:
    """The precision of the cell's control, as its limits file names it."""
    return json.loads((ROOT / "portbench" / "limits" / f"{cell.name}.json").read_text())["control"]


def reading(cell, seed, what, device="cuda"):
    """{name: value} of one seed's `what` (see the module's docstring)."""
    from portbench import faults
    from portbench.reference import precision
    from portbench.run import first_steps

    what = control_precision(cell) if what == "control" else what
    prob = cell.problem(seed, device)
    tr = cell.traffic
    train = cell.kind == "train"
    if what in faults.FAULTS:
        faults.FAULTS[what](prob)
    reference = what in precision.PRECISIONS
    if train:
        if reference:
            prob.free_program()
            history, first = prob.reference_train(tr["checked_steps"], what)
        else:
            history, first = first_steps(prob, tr["checked_steps"])
            prob.free_program()
        return prob.judge_train(history, first, detail=True)
    calls = range(tr["warmup"], tr["warmup"] + tr["samples"])
    if reference:
        prob.free_program()
        samples = [(i, prob.reference_solve(i, what)) for i in calls]
    else:
        samples = []
        for i in calls:
            out, _ = prob.solve(i)
            samples.append((i, prob.answer(out)))
        prob.free_program()
    return prob.judge_solve(samples, detail=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--what", default="program,control")
    args = ap.parse_args(argv)
    import torch

    from portbench.run import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(spec, args.workload)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"control_{args.workload}.jsonl", "a") as log:
        for what in args.what.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                line = json.dumps({"workload": args.workload, "seed": seed, "what": what,
                                   "readings": reading(cell, seed, what),
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                log.write(line + "\n")
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
