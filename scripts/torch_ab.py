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
  and the 16 x 16 x 128 grid's head levels, its operands built on the CPU
  and copied to the card; each with a sha256 of its inputs and of its
  outputs, so that two trees that should give the same bits can be
  compared (outputs only where the inputs agree: the plain assembly twin
  sums with atomics on the card, so the card-built systems may differ
  between processes in the last bit); and whether each tree's
  `whole_bwd_subst` equals the level backward sweep bit for bit.

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
            prob = make()
            bwd = [tuple(t.to(dev) for t in bw) for _, _, bw in cs.level_inputs(prob, *cs.plain_system(prob)[1:])]
            key = f"level_bwd_subst {label} {dn}"
            sha_in[key] = digest([t for bw in bwd for t in bw])
            sha[key] = digest([level_bwd_subst(*bw) for bw in bwd])
            ms[key] = cs.device_ms(lambda: [level_bwd_subst(*bw) for bw in bwd])
    torch.cuda.synchronize()
    return {"tree": str(tree), "card": cs.card_line(), "lm_iter_ms": lm, "device_ms": ms, "sha256": sha,
            "sha256_inputs": sha_in, "whole_bwd_equals_level_sweep": bwd_equal}


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
        pairs = [(a, b) for a in (0, 3) for b in (1, 2)
                 if runs[a]["sha256_inputs"][key] == runs[b]["sha256_inputs"][key]]
        same = all(runs[a]["sha256"][key] == runs[b]["sha256"][key] for a, b in pairs) if pairs else "n/a"
        print(f"{key:<38} device ms in run order: {cells}; outputs bit-equal across trees: {same} "
              f"(over the {len(pairs)} of 4 pairs of runs whose inputs agree)")
    for key, this in runs[1]["whole_bwd_equals_level_sweep"].items():
        print(f"{key:<36} equal to the level backward sweep bit for bit: other "
              f"{runs[0]['whole_bwd_equals_level_sweep'][key]}, this {this}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
