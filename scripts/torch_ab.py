"""Time one tree of theseus_tpu_torch against another on one card: the LM iteration and the kernels a change touches.

    python3 scripts/torch_ab.py               # the tree this script is in
    python3 scripts/torch_ab.py --tree DIR    # the tree unpacked in DIR
    python3 scripts/torch_ab.py --ab DIR      # DIR, this tree, this tree, DIR,
                                              # each in a process of its own

A tree is a checkout of the repository (for another commit, such as a
change's parent: `git archive` unpacked into a directory that .gitignore
lists); each builds its own kernels and is measured with its own
`chip_smoke.py` helpers. Run it for a change to a kernel or to the code
around a launch, to tell what the change moved end to end from what moved
between two calls (the host's speed differs from one call to the next).
Per tree, float32 unless stated:

- ms per LM iteration at PGO 256 x 128, level plan and whole-sweep plan
  (`chip_smoke.lm_iter_ms`: the marginal window of 20 iterations, min of
  3, each solve ended by a sync);
- device ms per call (`chip_smoke.device_ms`: CUDA events, the queue held
  by a sleep kernel while the host enqueues the calls), float32 and
  float64, of `between_se3` (kernel table row 1, through
  `between_linearize`) on the PGO Between operands at 256 x 128 (K = 257)
  and 64 x 16; of `reprojection` (row 5, through `reprojection_linearize`)
  on the BA Reprojection operands at 128 x 4000 x 1 and 16 x 200 x 16; and
  of `whole_fwd_subst` (row 7) and `whole_bwd_subst` (row 8) on the
  LM-damped PGO system at 256 x 128 and 2048 x 8 with the level kernels'
  factor (row 8 on the level forward sweep's y); and of one
  `level_bwd_subst` sweep (row 4b, every etree level of the plain-twin
  factor and solve, `chip_smoke.level_inputs`) at PGO 256 x 128, 2048 x 8
  and the 16 x 16 x 128 grid's head levels, its system built on the CPU
  and copied to the card; each with a sha256 of its inputs and of its
  outputs, so that two trees that should give the same bits can be
  compared (outputs only where the inputs agree: the plain assembly twin
  sums with atomics on the card, so the card-built systems may differ
  between processes in the last bit); and whether each tree's
  `whole_bwd_subst` equals the level backward sweep bit for bit;
- at the benchmark's sphere2500 cell (2500 poses, batch 64, float32 and
  float64: 94 head levels and a dense tail; `portbench/configs`, seed 7):
  the sha256 of the LM-damped system at its first pool draw (assembled by
  the kernel), of `factorize_levels`' blocks and dense tail, of the
  forward sweep's y, of the backward sweep's x, and of the poses after a
  10-iteration LM solve; the device and back-to-back ms of
  `factorize_levels`, `forward_sweep` and `backward_sweep`; and rows 3,
  4a and 4b (one sweep of each level kernel over the head's levels, back
  to back, device, and the plain twin's back to back: a tree whose level
  kernels read their operands in place counts those reads, an older
  tree's kernels read operands gathered beforehand); the peak bytes
  allocated and requested in one solve call.

Needs an NVIDIA GPU and nvcc. Prints the card's name and power limit and
one JSON line per tree; with --ab, then each measurement in run order and,
for the kernels, whether the outputs' bits agree between the trees.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
LM_SHAPE = (256, 128)
SPHERE_SEED = 7  # the sphere2500 problem's seed (the benchmark's generator)


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from theseus_tpu_torch import config
    from theseus_tpu_torch.ops.between_se3 import between_linearize
    from theseus_tpu_torch.ops.reprojection import reprojection_linearize
    from theseus_tpu_torch.sparse.cholesky import backward_sweep, factorize_levels, forward_sweep
    from theseus_tpu_torch.sparse.level_kernels import level_bwd_subst
    from theseus_tpu_torch.sparse.whole import whole_bwd_subst, whole_fwd_subst

    if not Path(cs.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {cs.__file__}, not the tree {tree}")
    dev = torch.device("cuda", 0)

    def digest(outs):
        h = hashlib.sha256()
        for t in outs:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    lm = {}
    for plan in ("level", "whole"):
        prob = cs.synthetic_problem(*LM_SHAPE, torch.float32, dev)
        config.set_whole_sweep(plan == "whole")
        try:
            lm["LM iteration PGO {}x{} {} plan".format(*LM_SHAPE, plan)] = cs.lm_iter_ms(prob)
        finally:
            config.set_whole_sweep(False)
    ms, sha, sha_in, bwd_equal = {}, {}, {}, {}
    rows, mem = {}, {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for n, b in ((256, 128), (64, 16)):
            ops = cs.between_operands(cs.synthetic_problem(n, b, dtype, dev))
            key = f"between_se3 {n}x{b} {dn}"
            sha_in[key] = digest(ops)
            sha[key] = digest(between_linearize(*ops))
            ms[key] = cs.device_ms(lambda: between_linearize(*ops))
        for shape in (cs.BA_MAIN, cs.BA_SMALL):
            rops = cs.reprojection_operands(cs.ba_problem(*shape, dtype, dev))
            key = "reprojection BA {}x{}x{} {}".format(*shape, dn)
            sha_in[key] = digest(rops)
            sha[key] = digest(reprojection_linearize(*rops))
            ms[key] = cs.device_ms(lambda: reprojection_linearize(*rops))
        for n, b in ((256, 128), (2048, 8)):
            prob, ata, atb = cs.whole_system(n, b, dtype, dev)
            sched = prob.builder.sched
            factor = factorize_levels(sched, ata)
            key = f"whole_fwd_subst {n}x{b} {dn}"
            sha_in[key] = digest([factor.blocks, atb])
            sha[key] = digest([whole_fwd_subst(sched, factor, atb)])
            ms[key] = cs.device_ms(lambda: whole_fwd_subst(sched, factor, atb))
            perm, iperm, _ = sched.on(dev)
            y = forward_sweep(sched, factor, atb[perm])
            key = f"whole_bwd_subst {n}x{b} {dn}"
            sha_in[key] = digest([factor.blocks, y])
            x = whole_bwd_subst(sched, factor, y)
            sha[key] = digest([x])
            bwd_equal[key] = bool(torch.equal(x, backward_sweep(sched, factor, y)[iperm]))
            ms[key] = cs.device_ms(lambda: whole_bwd_subst(sched, factor, y))
        cpu = torch.device("cpu")
        for label, make in (("PGO 256x128", lambda: cs.synthetic_problem(256, 128, dtype, cpu)),
                            ("PGO 2048x8", lambda: cs.synthetic_problem(2048, 8, dtype, cpu)),
                            ("grid {}x{}x{}".format(*cs.GRID), lambda: cs.grid_prob(dtype, cpu))):
            key = f"level_bwd_subst {label} {dn}"
            sha_in[key], sha[key], ms[key] = _bwd_sweep(cs, make(), dev, digest)
        _sphere2500(cs, dtype, dev, digest, ms, sha, sha_in, rows, mem)
    torch.cuda.synchronize()
    return {"tree": str(tree), "card": cs.card_line(), "lm_iter_ms": lm, "device_ms": ms, "sha256": sha,
            "sha256_inputs": sha_in, "whole_bwd_equals_level_sweep": bwd_equal, "level_rows_ms": rows,
            "memory_bytes": mem}


def _in_place(cs) -> bool:
    """The tree's level kernels read their operands in place (`level_kernels
    .level_stages`); an older tree's take operands gathered beforehand."""
    return hasattr(cs, "timing_sweeps")


def _bwd_sweep(cs, prob, dev, digest):
    """A level backward sweep on the card over the plain twins' system of
    prob, built on the CPU: (digest of each level's operands as the twin
    gathers them, digest of each level's x rows, device ms of the sweep's
    launches alone)."""
    import torch

    from theseus_tpu_torch.sparse.cholesky import Factor
    from theseus_tpu_torch.sparse import level_kernels as lk

    system = cs.plain_system(prob)[1:]
    if not _in_place(cs):
        ops = [tuple(t.to(dev) for t in bw) for _, _, bw in cs.level_inputs(prob, *system)]
        run = lambda: [lk.level_bwd_subst(*bw) for bw in ops]  # noqa: E731
        return digest([t for bw in ops for t in bw]), digest(run()), cs.device_ms(run)
    ata, factor, y, x, b = (a.to(dev) if isinstance(a, torch.Tensor) else Factor(*(
        None if t is None else t.to(dev) for t in a)) for a in system)
    levels = prob.builder.sched.on(dev)[2]
    stages = [lk.level_stages(t, ata, factor.blocks, y, x, b)[2] for t in levels]
    work = x.clone()
    return (digest([t for st in stages for t in st.operands()]),
            digest([st.run(lk.level_bwd_subst) for st in stages]),
            cs.device_ms(lambda: lk.level_bwd_subst(levels[::-1], factor.blocks, work, y)))


def _sphere2500(cs, dtype, dev, digest, ms, sha, sha_in, rows, mem):
    """The benchmark's sphere2500 cell at batch 64: the bits of the level
    plan's factor, y, x and a 10-iteration LM solve's poses, the ms of its
    three stages, and rows 3, 4a and 4b (see the module's docstring)."""
    import torch

    from portbench.configs.pgo_se3_sphere2500 import Problem
    from theseus_tpu_torch import config
    from theseus_tpu_torch.sparse import level_kernels as lk
    from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
    from theseus_tpu_torch.sparse.cholesky import backward_sweep, factorize_levels, forward_sweep

    cfg = json.loads((Path(cs.__file__).parent / "portbench/configs/pgo_se3_sphere2500.json").read_text())
    cfg["dtype"] = str(dtype).split(".")[-1]
    traffic = json.loads((Path(cs.__file__).parent / "portbench/traffic/solve_b64.json").read_text())
    p = Problem(cfg, traffic, SPHERE_SEED, dev)
    dn = cfg["dtype"]
    co = p.layer.objective.compile()
    values = p.layer.objective.default_values(p.inputs(0))
    bsz = traffic["batch"]
    state, aux = co.pack(values, bsz), co.build_aux(values, bsz)
    bld = p.layer.optimizer.normal_builder
    sched = bld.sched
    ata, atb = assemble(bld.pattern, co.linearize_blocks(state, aux))
    ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    perm, _, levels = sched.on(dev)
    b_perm = atb[perm]
    factor = factorize_levels(sched, ata)
    y = forward_sweep(sched, factor, b_perm)
    x = backward_sweep(sched, factor, y)
    key = f"sphere2500 {dn}"
    outs = {"factor": [factor.blocks, factor.tail], "y": [y], "x": [x], "LM states": [p.answer(p.solve(0)[0])]}
    for name, out in outs.items():
        sha_in[f"{key} {name}"] = digest([ata, atb])
        sha[f"{key} {name}"] = digest(out)
    # the memory a 10-iteration solve call holds at its peak: allocated (the
    # caching allocator's blocks, as the benchmark's memory_peak_bytes) and
    # requested (the tensors' own bytes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    p.solve(1)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(dev)
    for k in ("allocated_bytes.all.peak", "requested_bytes.all.peak"):
        mem[f"{key} solve {k}"] = stats.get(k)
    for name, fn in (("factorize_levels", lambda: factorize_levels(sched, ata)),
                     ("forward_sweep", lambda: forward_sweep(sched, factor, b_perm)),
                     ("backward_sweep", lambda: backward_sweep(sched, factor, y))):
        # one call a window: an older tree's sweep enqueues ~650 launches,
        # and the launch queue behind device_ms's sleep holds ~1024
        ms[f"{key} {name}"] = cs.device_ms(fn, reps=1, warmup=1)
        ms[f"{key} {name} back to back"] = cs.cuda_ms(fn, reps=5)
    if dtype != torch.float32:
        return
    # rows 3, 4a and 4b over the head's levels: one sweep each
    lflat = factor.blocks.clone()
    if _in_place(cs):
        sweeps = {"level_factor": (levels, ata, lflat), "level_fwd_subst": (levels, lflat, y.clone(), b_perm),
                  "level_bwd_subst": (levels[::-1], lflat, x.clone(), y)}
        calls = {k: ((lambda k=k, sw=sw: getattr(lk, k)(*sw)), (lambda k=k, sw=sw: getattr(lk, f"{k}_plain")(*sw)))
                 for k, sw in sweeps.items()}
    else:  # the kernels alone on operands gathered beforehand
        from theseus_tpu_torch.sparse import cholesky as chol

        lv = [(chol.factor_operands(t, ata, lflat), chol.fwd_operands(t, lflat, y, b_perm),
               chol.bwd_operands(t, lflat, x, y)) for t in levels]
        calls = {k: ((lambda i=i, k=k: [getattr(lk, k)(*ops[i]) for ops in lv]),
                     (lambda i=i, k=k: [getattr(lk, f"{k}_plain")(*ops[i]) for ops in lv]))
                 for i, k in enumerate(("level_factor", "level_fwd_subst", "level_bwd_subst"))}
    for k, (kern, plain) in calls.items():
        rows[f"{k} sphere2500 float32 {len(levels)} levels"] = {
            "back_to_back_ms": cs.cuda_ms(kern, reps=5), "device_ms": cs.device_ms(kern, reps=3, warmup=1),
            "plain_ms": cs.cuda_ms(plain, reps=3, warmup=1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, help="the other tree: runs it, this one, this one, it")
    args = ap.parse_args()
    if args.ab is None:
        print(json.dumps(measure(args.tree)))
        return 0
    runs = []
    for tree in (args.ab, HERE, HERE, args.ab):
        out = subprocess.run([sys.executable, __file__, "--tree", str(tree)], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    print(runs[0]["card"])
    names = ("other", "this", "this", "other")
    for key in runs[0]["lm_iter_ms"]:
        cells = ", ".join(f"{nm} {r['lm_iter_ms'][key]:.4f}" for nm, r in zip(names, runs))
        print(f"{key:<36} ms in run order: {cells}")
    for key in runs[0]["device_ms"]:
        cells = ", ".join(f"{nm} {r['device_ms'][key]:.4f}" for nm, r in zip(names, runs))
        print(f"{key:<38} device ms in run order: {cells}")
    for key in runs[0]["sha256"]:
        pairs = [(a, b) for a in (0, 3) for b in (1, 2)
                 if runs[a]["sha256_inputs"][key] == runs[b]["sha256_inputs"][key]]
        same = all(runs[a]["sha256"][key] == runs[b]["sha256"][key] for a, b in pairs) if pairs else "n/a"
        print(f"{key:<38} outputs bit-equal across trees: {same} "
              f"(over the {len(pairs)} of 4 pairs of runs whose inputs agree)")
    for key in runs[0]["memory_bytes"]:
        cells = ", ".join(f"{nm} {r['memory_bytes'][key]}" for nm, r in zip(names, runs))
        print(f"{key:<60} in run order: {cells}")
    for key in runs[0]["level_rows_ms"]:
        for field in ("back_to_back_ms", "device_ms", "plain_ms"):
            cells = ", ".join(f"{nm} {r['level_rows_ms'][key][field]:.4f}" for nm, r in zip(names, runs))
            print(f"{key:<44} {field} in run order: {cells}")
    for key, this in runs[1]["whole_bwd_equals_level_sweep"].items():
        print(f"{key:<36} equal to the level backward sweep bit for bit: other "
              f"{runs[0]['whole_bwd_equals_level_sweep'][key]}, this {this}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
