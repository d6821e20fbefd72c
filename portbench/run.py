#!/usr/bin/env python3
"""The benchmark of theseus_tpu_torch: runs one cell of BENCHMARK.json once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Everything is found by name: the cell in BENCHMARK.json; its
configuration's sizes in the file BENCHMARK.json names and its generator
beside it (configs/<config>.py); its traffic in traffic/<traffic>.json;
its limits in limits/<cell>.json; each per-layer metric's reader in
metrics/<metric>.py.

A run: set-up (build the problem and the program on it from the seed, a
pool of input draws on the card, warm-up calls of the cell's own shapes)
until the first timed call; then a closed loop, one call after another,
each synchronised, inputs cycling through the pool, until the first call
that ends after --seconds. With --trace 1 a few calls a third of the way
in are profiled. After the window: the peak memory, the program freed, and
the sampled answers held against the plain reference (reference/). The
last line of standard output is one JSON object; the numbers compared are
the last lines of standard error and the last key of that object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "theseus_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (default: the loaded
    modules), each name compared whole up to its first dot."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and limits."""

    def __init__(self, spec: dict, name: str, cfg_override=None, traffic_override=None):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, cells[name]
        config = next(c for c in spec["configs"] if c["name"] == self.entry["config"])
        self.cfg_path = ROOT / config["file"]
        self.cfg = json.loads(self.cfg_path.read_text())
        self.cfg.update(cfg_override or {})
        self.traffic = json.loads((HERE / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.traffic.update(traffic_override or {})
        self.limits = json.loads((HERE / "limits" / f"{name}.json").read_text())["limits"]
        self.kind = self.traffic["kind"]
        self.e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]

    def problem(self, seed: int, device):
        mod = load_module(self.cfg_path.with_suffix(".py"), f"portbench_config_{self.entry['config']}")
        return mod.Problem(self.cfg, self.traffic, seed, device, train=self.kind == "train")


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def first_steps(prob, n: int):
    """The first n training steps, through the timed call: ([(loss, the
    parameter after the step)], the first forward's answer)."""
    history, first = [], None
    for i in range(n):
        loss, out = prob.train_step(i)
        history.append((float(loss), float(prob.parameter())))
        first = prob.answer(out) if first is None else first
    return history, first


def run_cell(spec, name, seed, seconds, trace, device="cuda", cfg_override=None, traffic_override=None,
             fault=None, t0=None):
    """One run of cell `name`; returns the result object. fault(problem),
    when given, is called on the problem as soon as it is built: tests break
    the timed path with it to see `correct` come out false."""
    import torch

    t0 = T0 if t0 is None else t0
    cell = Cell(spec, name, cfg_override, traffic_override)
    tr = cell.traffic
    train = cell.kind == "train"
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prob = cell.problem(seed, device)
    if fault is not None:
        fault(prob)
    # set-up ends with warm-up calls of the cell's own shapes; a training
    # cell's are its first steps, which the reference follows
    history, first_answer = [], None
    if train:
        history, first_answer = first_steps(prob, tr["checked_steps"])
    else:
        for i in range(tr["warmup"]):
            prob.solve(i)
    _sync(device)
    setup_s = time.perf_counter() - t0

    rng = random.Random(f"{seed}:samples")
    samples, statuses, losses, marks = [], [], [], []
    first = len(history) if train else tr["warmup"]
    profile = None
    prof_calls = prof_t0 = prof_wall = 0
    n = 0
    start = time.perf_counter()
    while True:
        i = first + n
        if trace and profile is None and prof_calls == 0 and time.perf_counter() - start >= seconds / 3:
            from torch.profiler import ProfilerActivity, profile as _profile

            profile = _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            _sync(device)
            profile.__enter__()
            prof_t0 = time.perf_counter()
        profiling = profile is not None and prof_calls < tr["profile_calls"]
        if train:
            if profiling:
                tm = time.perf_counter()

                def mark():
                    _sync(device)
                    marks.append([time.perf_counter() - tm])
                losses.append(prob.train_step(i, mark)[0])
                _sync(device)
                marks[-1].append(time.perf_counter() - tm - marks[-1][0])
            else:
                losses.append(prob.train_step(i)[0])
                _sync(device)
        else:
            out, info = prob.solve(i)
            statuses.append(info.status)
            # a reservoir sample of the window's answers, drawn from the seed
            if len(samples) < tr["samples"]:
                samples.append((i, prob.answer(out)))
            else:
                j = rng.randrange(n + 1)
                if j < tr["samples"]:
                    samples[j] = (i, prob.answer(out))
            del out, info
            _sync(device)
        n += 1
        if profiling:
            prof_calls += 1
            if prof_calls == tr["profile_calls"]:
                prof_wall = time.perf_counter() - prof_t0
                profile.__exit__(None, None, None)
        if time.perf_counter() - start >= seconds and (not trace or prof_calls >= tr["profile_calls"]):
            break
    window = time.perf_counter() - start

    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    batch = tr["batch"]
    if train:
        lv = torch.stack(losses).float().cpu()
        attempted, failed = len(losses), int((~torch.isfinite(lv)).sum())
    else:
        st = torch.stack(statuses).cpu()
        attempted, failed = n * batch, int((st == -1).sum())
    metrics = {}
    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                     "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        from portbench import trace_reduce as tr_mod
        from portbench.counts import peaks

        dev_ops, host_ops = tr_mod.split_events(profile)
        busy = tr_mod.busy_seconds(dev_ops)
        ctx = SimpleNamespace(kind=cell.kind, dev=dev_ops, host=host_ops, busy_s=busy, window_s=prof_wall,
                              calls=prof_calls, shapes=prob.shapes(), itemsize=4, marks=marks,
                              iterations=prof_calls * prob.shapes()["iterations"])
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py", "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device["busy_s"] = busy
        result_device["window_s"] = prof_wall
        breakdown = {"device_ops": tr_mod.top_device_ops(dev_ops), "idle_gaps": tr_mod.idle_gaps(dev_ops, host_ops)}
        print(peaks.describe(), file=sys.stderr)
        del profile, dev_ops, host_ops, ctx
    else:
        rates = {"solve": ("solves_per_s", n * batch / window), "train": ("train_steps_per_s", n / window)}
        key, value = rates[cell.kind]
        units = {m["name"]: m["unit"] for m in cell.e2e}
        metrics[key] = {"value": value, "unit": units[key]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}

    # the program's state goes before the reference runs, so that the
    # reference neither sets the peak nor lacks room
    prob.free_program()
    del statuses, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = prob.judge_train(history, first_answer) if train else prob.judge_solve(samples)
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # every compile cache at a fixed path inside the checkout (the program's
    # own kernel and symbolic builds live in theseus_tpu_torch/_build)
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        ap.error(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import theseus_tpu_torch
    except ImportError as e:
        print(f"the program theseus_tpu_torch is not in this checkout: {e}", file=sys.stderr)
        return 2
    if ROOT not in Path(theseus_tpu_torch.__file__).resolve().parents:
        print(f"theseus_tpu_torch was loaded from {theseus_tpu_torch.__file__}, outside the checkout", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, args.trace, device="cuda")
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    # run as a script, this directory heads sys.path; its modules are
    # imported as portbench.* from the checkout's root instead, so that none
    # of them stands in for a module of the same name elsewhere
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.exit(main())
