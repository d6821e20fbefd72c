#!/usr/bin/env python3
"""On-card check of theseus_tpu_torch: the batched SE3 pose-graph LM solve on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

It imports neither jax nor theseus_tpu. In order:

1. fails fast without a CUDA device or outside a checkout;
2. builds the CUDA kernels from theseus_tpu_torch/csrc (nvcc, sm_90a) and
   prints the build time and each d=6 kernel's registers and spills;
3. kernel phase: every kernel against its plain PyTorch twin on the card, at
   the shapes of the 256-pose x batch-128 problem (Between at K=257,
   B=128; the assembly of both buckets; every etree level's (C, rl, ul)),
   in float32 and float64, each line with its deviation and tolerance;
4. slice phase: `TheseusLayer.forward` at 256 x 128 in float32 with the
   launch counters reset just before and read just after; the converged
   plateau against the plain-twin float64 solve on the card; the 64 x 16
   problem from the committed JAX float64 golden; a few more requests on
   fresh inputs; one solve with the high-precision tier (refinement) on;
5. timing phase: ms per LM iteration (marginal window, as bench.py) at
   64 x 16 and 256 x 128 for the kernel path and the plain-twin path, and
   each kernel against its twin at the main-path shapes (CUDA events);
6. prints one JSON line of kernel results, the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "pgo_64x16_jax_f64.npz"
ITERS = 30  # enough for the 256 x 128 and 64 x 16 solves to sit on their plateau

# Kernel against twin, same inputs: max |kernel - twin| <= TOL * max(1, max |twin|).
# Default: float32 2e-5 (native sqrt/atan2 against torch's, FMA contraction
# and another summation order: about a hundred ulp of the output's scale);
# float64 1e-12 (the same formulas, only the rounding order differs).
# Between: its jlog coefficients (c, d of se3.jlog) are differences of O(theta^2)
# terms that cancel to O(theta^6) just above the derivative-branch switch
# (theta = 0.2 in float32), and the 256 x 128 initial state sits there. The
# float32 twin is itself 1.3e-3 (same scale) away from its float64 evaluation
# on the same inputs (measured on the CPU), so two float32 implementations
# may differ by that much: 2e-3. The same amplification (~1e4 eps) in
# float64 gives ~2e-12: 1e-10.
KERNEL_TOL = {
    "float32": {"between_se3": 2e-3, "default": 2e-5},
    "float64": {"between_se3": 1e-10, "default": 1e-12},
}
TOL_REASON = {
    "float32": {"between_se3": "f32 jlog cancellation near theta=0.2, atan2",
                "default": "summation order, FMA"},
    "float64": {"between_se3": "jlog cancellation at 1e4 eps",
                "default": "same formulas, rounding order"},
}
# Per-batch final error of a float32 kernel solve against a float64 solve of
# the same problem. float32 LM without the high-precision tier stalls within
# 3.4e-4 of the float64 plateau on these problems (the port's CPU twins,
# float32 against float64); 2e-3 leaves room for the card's rounding order.
PLATEAU_RTOL_F32 = 2e-3
# float64 kernels against the JAX float64 golden: converged float64 plateaus
PLATEAU_RTOL_F64 = 1e-8

KERNEL_INFO = {
    "between_se3": ("theseus_tpu_torch/csrc/between_se3.cu", "theseus_tpu/ops/pallas_between_soa.py:321"),
    "assemble_blocks": ("theseus_tpu_torch/csrc/assemble_blocks.cu", "theseus_tpu/sparse/pallas_assemble.py:124"),
    "level_factor": ("theseus_tpu_torch/csrc/level_factor.cu", "theseus_tpu/sparse/pallas_factorize.py:118"),
    "level_fwd_subst": ("theseus_tpu_torch/csrc/level_subst.cu", "theseus_tpu/sparse/pallas_factorize.py:260"),
    "level_bwd_subst": ("theseus_tpu_torch/csrc/level_subst.cu", "theseus_tpu/sparse/pallas_factorize.py:260"),
}


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------
class Problem:
    """A PGO problem on the card: objective, layer, packed state and aux."""

    def __init__(self, obj, inputs, iters=ITERS):
        import theseus_tpu_torch as tt

        self.obj = obj
        self.inputs = inputs
        self.layer = tt.TheseusLayer(
            tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True)
        )
        self.opt = self.layer.optimizer
        self.co = obj.compile()
        values = obj.default_values(inputs)
        self.batch = self.co.resolve_batch_size(values)
        self.state = self.co.pack(values, self.batch)
        self.aux = self.co.build_aux(values, self.batch)
        self.builder = self.opt.normal_builder


def synthetic_problem(n, b, dtype, dev, seed=0):
    from theseus_tpu_torch.utils.examples.pose_graph import (
        build_pgo_objective, pose_values, synthetic_pose_graph)

    gt, edges, meas, init = synthetic_pose_graph(n, b, seed=seed, dtype=dtype, device=dev)
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=dtype, device=dev)
    return Problem(obj, pose_values(init))


def golden_problem(dtype, dev):
    from theseus_tpu_torch.utils.convert import load_problem_npz

    obj, inputs = load_problem_npz(GOLDEN, dtype=dtype, device=dev)
    return Problem(obj, inputs)


def golden_errors():
    import numpy as np

    with np.load(GOLDEN) as f:
        return np.array(f["final_err"]), int(f["n_iters"])


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build():
    from theseus_tpu_torch import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    print(f"[build] {path.relative_to(ROOT)} ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc time {_cuda.build_seconds:.2f} s; 0 means a cached build was reused)")
    # the -Xptxas -v report for the d = 6 instantiations the PGO path runs
    log = _cuda.build_log().splitlines()
    for i, line in enumerate(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m:
            continue
        name = m.group(1)
        if not ("between_se3" in name or "Li6E" in name):
            continue
        kind = next(k for k in ("between_se3", "assemble", "level_factor", "fwd_subst", "bwd_subst")
                    if k in name)
        dt = "f64" if "kernelId" in name else "f32"
        info = " ".join(l.strip() for l in log[i + 1 : i + 5])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        print(f"[build] {kind:<13} {dt}: {regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spilled")


# ---------------------------------------------------------------------------
# phase 3: kernels against twins at the 256 x 128 shapes
# ---------------------------------------------------------------------------
def _dev_report(name, dtype_name, got, want, shape_note=""):
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        check(bool(torch.isfinite(g).all()), f"{name} {dtype_name}: non-finite kernel output")
        scale = max(1.0, float(w.abs().max()))
        worst_abs = max(worst_abs, float((g - w).abs().max()))
        worst_rel = max(worst_rel, float((g - w).abs().max()) / scale)
    tol = KERNEL_TOL[dtype_name].get(name, KERNEL_TOL[dtype_name]["default"])
    reason = TOL_REASON[dtype_name].get(name, TOL_REASON[dtype_name]["default"])
    verdict = "ok" if worst_rel <= tol else "FAIL"
    print(f"[kernel] {name:<15} {dtype_name} {shape_note:<26} max_abs={worst_abs:.3e} "
          f"max_rel(to max(1,|twin|))={worst_rel:.3e} tol={tol:.0e} ({reason}) {verdict}")
    check(worst_rel <= tol, f"{name} {dtype_name}: kernel deviates from its twin by {worst_rel:.3e} > {tol}")
    return worst_abs


def level_inputs(prob, ata, lflat, y, x, b_perm):
    """Per-level operands of the three level kernels, gathered by the
    solver's own functions from a plain-twin factorization and solve."""
    from theseus_tpu_torch.sparse.cholesky import bwd_operands, factor_operands, fwd_operands

    _, _, levels = prob.builder.sched.on(ata.device)
    return [(factor_operands(t, ata, lflat), fwd_operands(t, lflat, y, b_perm),
             bwd_operands(t, lflat, x, y)) for t in levels]


def plain_system(prob):
    """Plain-twin linearization, assembly (LM-damped), factor and both
    substitution sweeps, keeping the intermediates."""
    from theseus_tpu_torch import config
    from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
    from theseus_tpu_torch.sparse.cholesky import backward_sweep, factorize, forward_sweep

    bld = prob.builder
    with config.plain_path():
        blocks = prob.co.linearize_blocks(prob.state, prob.aux)
        ata, atb = assemble(bld.pattern, blocks)
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
        lflat = factorize(bld.sched, ata)
        perm, _, _ = bld.sched.on(ata.device)
        b_perm = atb[perm]
        y = forward_sweep(bld.sched, lflat, b_perm)
        x = backward_sweep(bld.sched, lflat, y)
    return blocks, ata, lflat, y, x, b_perm


def between_operands(prob):
    from theseus_tpu_torch.embodied import Between

    for bi, bk in enumerate(prob.co.buckets):
        if isinstance(bk.template, Between):
            v1, v2 = prob.co.gather_optim(bk, prob.state)
            return v1, v2, prob.aux[bi][0][0]
    raise CheckFailed("no Between bucket")


def phase_kernels(dev):
    import torch

    from theseus_tpu_torch.ops.between_se3 import between_linearize, between_linearize_plain
    from theseus_tpu_torch.sparse.assemble import _pad_jac
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
    from theseus_tpu_torch.sparse.level_kernels import (
        level_bwd_subst, level_bwd_subst_plain, level_factor, level_factor_plain,
        level_fwd_subst, level_fwd_subst_plain)

    max_abs = {}
    shapes = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        prob = synthetic_problem(256, 128, dtype, dev)
        v1, v2, meas = between_operands(prob)
        note = f"K={v1.shape[0]} B={v1.shape[1]}"
        e = _dev_report("between_se3", dn, between_linearize(v1, v2, meas),
                        between_linearize_plain(v1, v2, meas), note)
        max_abs.setdefault("between_se3", {})[dn] = e

        blocks, ata, lflat, y, x, b_perm = plain_system(prob)
        d = prob.builder.pattern.d
        padded = [([_pad_jac(j, d) for j in jacs], err) for jacs, err in blocks]
        note = "buckets K=" + ",".join(str(err.shape[0]) for _, err in blocks)
        e = _dev_report("assemble_blocks", dn, assemble_blocks(prob.builder.pattern, padded),
                        assemble_blocks_plain(prob.builder.pattern, padded), note)
        max_abs.setdefault("assemble_blocks", {})[dn] = e

        worst = {"level_factor": 0.0, "level_fwd_subst": 0.0, "level_bwd_subst": 0.0}
        lv = level_inputs(prob, ata, lflat, y, x, b_perm)
        shapes[dn] = [(f[0].shape[0], f[0].shape[1], f[1].shape[1]) for f, _, _ in lv]
        for li, (fact, fwd, bwd) in enumerate(lv):
            C, ul, rl = fact[0].shape[0], fact[1].shape[1], fact[0].shape[1]
            note = f"level {li:2d} C={C} rl={rl} ul={ul}"
            worst["level_factor"] = max(worst["level_factor"], _dev_report(
                "level_factor", dn, level_factor(*fact), level_factor_plain(*fact), note))
            worst["level_fwd_subst"] = max(worst["level_fwd_subst"], _dev_report(
                "level_fwd_subst", dn, level_fwd_subst(*fwd), level_fwd_subst_plain(*fwd), note))
            worst["level_bwd_subst"] = max(worst["level_bwd_subst"], _dev_report(
                "level_bwd_subst", dn, level_bwd_subst(*bwd), level_bwd_subst_plain(*bwd), note))
        for k, v in worst.items():
            max_abs.setdefault(k, {})[dn] = v
    torch.cuda.synchronize()
    print(f"[kernel] 256x128 levels (C, rl, ul): {shapes['float32']}")
    return max_abs


# ---------------------------------------------------------------------------
# phase 4: the slice through TheseusLayer.forward
# ---------------------------------------------------------------------------
def _rel(a, b):
    return (a.double().cpu() - b.double().cpu()).abs() / b.double().cpu().abs()


def phase_slice(dev):
    import numpy as np
    import torch

    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.lie import se3

    # (a) the main path: 256 x 128, float32, kernels; counters around it only
    prob = synthetic_problem(256, 128, torch.float32, dev)
    n_levels = len(prob.builder.sched.level_tables)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out, info = prob.layer.forward(prob.inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    print(f"[slice] 256x128 float32 forward, {ITERS} LM iterations: {wall:.3f} s wall, "
          f"mean final err {float(info.last_err.mean()):.8e}, launches {launches}")
    expect = {
        "between_se3": 2 * ITERS + 1,  # linearize + tentative error per iteration, + initial error
        "assemble_blocks": ITERS,
        "level_factor": ITERS * n_levels,
        "level_fwd_subst": ITERS * n_levels,
        "level_bwd_subst": ITERS * n_levels,
    }
    for k, v in expect.items():
        check(launches[k] > 0, f"{k} was never launched by the main path")
        check(launches[k] == v, f"{k}: {launches[k]} launches, expected {v}")
    check(bool(torch.isfinite(info.last_err).all()), "non-finite final error")
    for name, t in out.items():
        if name.startswith("pose_"):
            check(tuple(t.shape) == (128, 3, 4) and bool(torch.isfinite(t).all()),
                  f"{name}: bad output {tuple(t.shape)}")

    # (b) the same problem, float64, plain twins on the card
    ref = synthetic_problem(256, 128, torch.float64, dev)
    _cuda.reset_launches()
    with config.plain_path():
        _, ref_info = ref.layer.forward(ref.inputs)
    check(sum(_cuda.launches.values()) == 0, "the plain path launched a kernel")
    rel = _rel(info.last_err, ref_info.last_err)
    print(f"[slice] 256x128 float32 kernels vs float64 plain twins on the card: "
          f"max rel dev of per-batch final error {float(rel.max()):.3e} (tol {PLATEAU_RTOL_F32:.0e}); "
          f"float64 mean final err {float(ref_info.last_err.mean()):.8e}")
    check(float(rel.max()) <= PLATEAU_RTOL_F32, "float32 plateau off the float64 plateau")

    # (c) the JAX float64 golden at 64 x 16
    golden, golden_iters = golden_errors()
    check(golden_iters == ITERS, "golden iteration count changed")
    golden_t = torch.as_tensor(golden)
    for dtype, tol in ((torch.float32, PLATEAU_RTOL_F32), (torch.float64, PLATEAU_RTOL_F64)):
        g = golden_problem(dtype, dev)
        _, ginfo = g.layer.forward(g.inputs)
        rel = _rel(ginfo.last_err, golden_t)
        dn = str(dtype).split(".")[-1]
        print(f"[slice] 64x16 {dn} kernels vs JAX float64 golden: max rel dev {float(rel.max()):.3e} "
              f"(tol {tol:.0e}); mean {float(ginfo.last_err.mean()):.8e} vs {float(golden.mean()):.8e}")
        check(float(rel.max()) <= tol, f"64x16 {dn} off the JAX golden")

    # more requests: the 256 x 128 problem from fresh inits (a small random
    # right-perturbation of every pose, as a new request would bring)
    gen = np.random.default_rng(1)
    for r in range(3):
        fresh = {}
        for name, pose in prob.inputs.items():
            tangent = torch.as_tensor(1e-2 * gen.standard_normal(tuple(pose.shape[:-2]) + (6,)),
                                      dtype=torch.float32, device=dev)
            fresh[name] = se3.compose(pose, se3.exp(tangent))
        _, rinfo = prob.layer.forward(fresh)
        rel = _rel(rinfo.last_err, ref_info.last_err)
        print(f"[slice] request {r + 1}: fresh init, mean final err {float(rinfo.last_err.mean()):.8e}, "
              f"max rel dev from the float64 plateau {float(rel.max()):.3e}")
        check(bool(torch.isfinite(rinfo.last_err).all()), "fresh request: non-finite error")
        check(float(rel.max()) <= PLATEAU_RTOL_F32, "fresh request: off the plateau")

    # the high-precision tier: Atb in float64 and one refinement sweep per
    # solve, which reuses both substitution kernels
    config.set_high_precision_tier(True)
    try:
        g = golden_problem(torch.float32, dev)
        n_lv = len(g.builder.sched.level_tables)
        _cuda.reset_launches()
        _, hinfo = g.layer.forward(g.inputs)
        subst = _cuda.launches["level_fwd_subst"]
    finally:
        config.set_high_precision_tier(False)
    rel = _rel(hinfo.last_err, golden_t)
    print(f"[slice] 64x16 float32 with the high-precision tier: max rel dev from the golden "
          f"{float(rel.max()):.3e}; forward-substitution launches {subst} "
          f"(= 2 sweeps x {n_lv} levels x {ITERS} iterations)")
    check(subst == 2 * n_lv * ITERS, "refinement did not reuse the substitution kernels")
    check(float(rel.max()) <= PLATEAU_RTOL_F32, "high-precision tier off the golden")
    return launches


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------
def lm_iter_ms(prob, n_small=5, extra=20, reps=3):
    """Marginal ms per LM iteration, (t(N+K) - t(N)) / K (bench.py's
    window), each call on a freshly perturbed state, ended by a sync."""
    import torch

    opt, opts = prob.opt, prob.opt.opts

    def run(n, i):
        state = {k: v * (1.0 + 1e-7 * (i + 1)) for k, v in prob.state.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            carry = opt.run_scan(opt.init_carry(state, prob.aux, opts), prob.aux, n, opts)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, carry

    _, carry = run(n_small, 0)  # warm-up
    check(bool(torch.isfinite(carry["err"]).all()), "timing solve: non-finite error")
    t_small = min(run(n_small, i)[0] for i in range(reps))
    t_large = min(run(n_small + extra, i)[0] for i in range(reps))
    return (t_large - t_small) / extra * 1e3


def cuda_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev, card):
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.ops.between_se3 import between_linearize, between_linearize_plain
    from theseus_tpu_torch.sparse.assemble import _pad_jac
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
    from theseus_tpu_torch.sparse.level_kernels import (
        level_bwd_subst, level_bwd_subst_plain, level_factor, level_factor_plain,
        level_fwd_subst, level_fwd_subst_plain)

    iters = {}
    for label, prob in (("64x16", golden_problem(torch.float32, dev)),
                        ("256x128", synthetic_problem(256, 128, torch.float32, dev))):
        kern = lm_iter_ms(prob)
        with config.plain_path():
            plain = lm_iter_ms(prob)
        iters[label] = (kern, plain)
        print(f"[timing] {label} float32 LM iteration: kernels {kern:.4f} ms, plain twins "
              f"{plain:.4f} ms (marginal over 20 iterations, min of 3) on {card}")

    prob = synthetic_problem(256, 128, torch.float32, dev)
    v1, v2, meas = between_operands(prob)
    blocks, ata, lflat, y, x, b_perm = plain_system(prob)
    d = prob.builder.pattern.d
    padded = [([_pad_jac(j, d) for j in jacs], err) for jacs, err in blocks]
    pattern = prob.builder.pattern
    lv = level_inputs(prob, ata, lflat, y, x, b_perm)
    pairs = {
        "between_se3": (lambda: between_linearize(v1, v2, meas),
                        lambda: between_linearize_plain(v1, v2, meas)),
        "assemble_blocks": (lambda: assemble_blocks(pattern, padded),
                            lambda: assemble_blocks_plain(pattern, padded)),
        "level_factor": (lambda: [level_factor(*f) for f, _, _ in lv],
                         lambda: [level_factor_plain(*f) for f, _, _ in lv]),
        "level_fwd_subst": (lambda: [level_fwd_subst(*f) for _, f, _ in lv],
                            lambda: [level_fwd_subst_plain(*f) for _, f, _ in lv]),
        "level_bwd_subst": (lambda: [level_bwd_subst(*f) for _, _, f in lv],
                            lambda: [level_bwd_subst_plain(*f) for _, _, f in lv]),
    }
    times = {}
    for name, (k, p) in pairs.items():
        times[name] = (cuda_ms(k), cuda_ms(p))
        what = "one sweep over all levels" if name.startswith("level") else "one call"
        print(f"[timing] {name:<15} 256x128 float32, {what}: kernel {times[name][0]:.4f} ms, "
              f"plain twin {times[name][1]:.4f} ms (CUDA events, mean of 20) on {card}")
    return iters, times


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "theseus_tpu_torch" / "__init__.py").exists() or not GOLDEN.exists():
        print("chip_smoke: run from the root of a theseus_tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase_build()
    max_abs = phase_kernels(dev)
    launches = phase_slice(dev)
    iters, times = phase_timing(dev, card)
    check("jax" not in sys.modules and "theseus_tpu" not in sys.modules, "jax was imported")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_abs[name]["float32"],
            "ms": times[name][0], "plain_ms": times[name][1],
        })
    print(json.dumps({"lm_iter_ms": {k: {"kernels": v[0], "plain": v[1]} for k, v in iters.items()}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
