"""Time theseus_tpu_torch's kernels whose block size was chosen by timing, at each candidate size.

Six kernels (PERF.md kernel table rows 1, 5, 4b, 6, 7 and 8):

- `between_se3` (`csrc/between_se3.cu`) and `reprojection`
  (`csrc/reprojection.cu`): the block size is a launch argument, which
  `_cuda.tile_geometry` picks (64, 128 or 256 threads); here each size is
  launched through the package library's own entry point;
- `level_bwd_subst` (`csrc/level_subst.cu`): the batch tile bt (a block
  has bt d threads), which `bwd_subst_geometry` picks per level; here one
  bt for every level of a sweep (capped at the batch, the rows a chunk
  `bwd_subst_rows`), bt = 1, 2, ..., 32, reading the plain-twin factor and
  y in place at PGO 256 x 128, 2048 x 8 and the 16 x 16 x 128 grid's head
  levels, against one sweep of the package's launches;
- `whole_factor` (`csrc/whole_factor.cu`): the constant `WF_THREADS`
  (1024), which also sets the launch bounds and so the registers a thread
  may use (64 at 1024 threads, 128 at 512, 255 at 256);
- `whole_fwd_subst` and `whole_bwd_subst` (`csrc/whole_subst.cu`): the
  constants `WFS_THREADS` (512) and `WBS_THREADS` (256), likewise.

For the last three, a copy of the source is compiled per block size into
`theseus_tpu_torch/_build/block_sizes/<kernel>/<threads>/` and loaded as a
library of its own. On the PGO problems (Between at 256 x 128 and 64 x 16;
the LM-damped systems at 256 x 128 and 2048 x 8 for the whole-sweep
kernels, the backward sweep on the level forward sweep's y) and the BA
problems (Reprojection at 128 x 4000 x 1 and 16 x 200 x 16), in float32
and float64, each block size:

- must give the package kernel's outputs bit for bit (the arithmetic does
  not depend on the block size);
- is timed as device ms per call (`chip_smoke.device_ms`: CUDA events, the
  queue held by a sleep kernel while the host enqueues the calls).

ptxas's registers and spill stores of the d = 6 kernels are printed for
the rebuilt copies. Needs an NVIDIA Hopper GPU and nvcc. Run from the
repository root, for every kernel or the ones named:

    python3 scripts/torch_block_sizes.py [between_se3 reprojection level_bwd_subst whole_factor whole_fwd_subst
                                          whole_bwd_subst]

It prints the card's name and power limit, then one line per build and per
measurement, and exits non-zero if a block size changed an output.
"""

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TILE_THREADS = (64, 128, 256)
BETWEEN_SHAPES = ((256, 128), (64, 16))
WHOLE_SHAPES = ((256, 128), (2048, 8))
# kernel -> (source, the constant's line, its name in ptxas's report, block sizes)
REBUILT = {
    "whole_factor": ("whole_factor.cu", "constexpr int WF_THREADS = {};", "whole_factor_kernel", 1024,
                     (256, 512, 1024)),
    "whole_fwd_subst": ("whole_subst.cu", "constexpr int WFS_THREADS = {};", "whole_fwd_kernel", 512,
                        (256, 512, 1024)),
    "whole_bwd_subst": ("whole_subst.cu", "constexpr int WBS_THREADS = {};", "whole_bwd_kernel", 256,
                        (128, 256, 512)),
}
BWD_TILES = (1, 2, 4, 8, 16, 32)
KERNELS = ("between_se3", "reprojection", "level_bwd_subst") + tuple(REBUILT)


def build(kernel, threads):
    """Start nvcc on a copy of the kernel's source with its block constant
    set to threads: (the build directory, the nvcc process)."""
    from theseus_tpu_torch import _cuda

    source, line, _, default, _ = REBUILT[kernel]
    src = (_cuda.CSRC / source).read_text()
    if line.format(default) not in src:
        raise RuntimeError(f"{source} no longer holds {line.format(default)!r}")
    out = _cuda.build_root() / "block_sizes" / kernel / str(threads)
    out.mkdir(parents=True, exist_ok=True)
    (out / source).write_text(src.replace(line.format(default), line.format(threads)))
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC), str(out / source),
           "-o", str(out / "lib.so")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def ptxas_d6(report, entry):
    """{dtype: (registers, spill store bytes)} of the d = 6 instances of the
    entry function, the worst of its variants."""
    res, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        k = re.search(rf"{entry}I([fd])Li6E", name or "")
        if m and k:
            key = "float32" if k.group(1) == "f" else "float64"
            regs, sp = res.get(key, (0, 0))
            res[key] = (max(regs, int(m.group(1))), max(sp, spill))
    return res


def between_sizes(dev, card):
    """Each Between block size against the package's launch, bit for bit,
    and its device time."""
    import torch

    import chip_smoke as cs
    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.config import get_eps
    from theseus_tpu_torch.ops.between_se3 import BETWEEN_TILE, between_geometry, between_linearize

    same = []
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        fn = getattr(_cuda.lib(), f"th_between_se3_{_cuda.suffix(dtype)}")
        eps = [get_eps("so3", e, dtype) for e in ("near_zero", "near_pi", "d_near_zero")]
        for n, b in BETWEEN_SHAPES:
            v1, v2, meas = cs.between_operands(cs.synthetic_problem(n, b, dtype, dev))
            ref = between_linearize(v1, v2, meas)
            v1, v2, meas = v1.contiguous(), v2.contiguous(), meas.expand(v1.shape)
            if meas.stride(-1) != 1 or meas.stride(-2) != 4:
                meas = meas.contiguous()
            k = v1.shape[0]
            pick = between_geometry(k * b, v1.element_size(), _cuda.tile_min_blocks(dev.index))[0]
            for t in TILE_THREADS:
                outs = [torch.empty_like(r) for r in ref]

                def call():
                    rc = fn(v1.data_ptr(), v2.data_ptr(), meas.data_ptr(), meas.stride(0), meas.stride(1), k, b,
                            *eps, t, BETWEEN_TILE * t * v1.element_size(), *(o.data_ptr() for o in outs),
                            _cuda.stream_of(v1))
                    if rc != 0:
                        raise RuntimeError(f"between_se3 at {t} threads: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                same.append(all(torch.equal(o, r) for o, r in zip(outs, ref)))
                ms = cs.device_ms(call)
                print(f"[time] between_se3 {dn} PGO {n}x{b} (K B = {k * b}) {t} threads: {ms:.4f} ms device, "
                      f"bitwise equal to the package's launch: {same[-1]} (the geometry picks {pick}) on {card}")
    return same


def reprojection_sizes(dev, card):
    """Each Reprojection block size against the package's launch, bit for
    bit, and its device time."""
    import torch

    import chip_smoke as cs
    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.ops.reprojection import (
        REPROJECTION_TILE, broadcast_aux, reprojection_geometry, reprojection_linearize)

    same = []
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        fn = getattr(_cuda.lib(), f"th_reprojection_{_cuda.suffix(dtype)}")
        for shape in (cs.BA_MAIN, cs.BA_SMALL):
            ops = cs.reprojection_operands(cs.ba_problem(*shape, dtype, dev))
            ref = reprojection_linearize(*ops)
            pose, point = ops[0].contiguous(), ops[1].contiguous()
            aux = [a if a.stride(-1) == 1 else a.contiguous() for a in broadcast_aux(pose, ops[2:])]
            strides = [s for a in aux for s in (a.stride(0), a.stride(1))]
            k, b, isz = pose.shape[0], pose.shape[1], pose.element_size()
            pick = reprojection_geometry(k * b, isz, _cuda.tile_min_blocks(dev.index))[0]
            for t in TILE_THREADS:
                outs = [torch.empty_like(r) for r in ref]

                def call():
                    rc = fn(pose.data_ptr(), point.data_ptr(), *(a.data_ptr() for a in aux), *strides, k, b, t,
                            REPROJECTION_TILE * t * isz, *(o.data_ptr() for o in outs), _cuda.stream_of(pose))
                    if rc != 0:
                        raise RuntimeError(f"reprojection at {t} threads: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                same.append(all(torch.equal(o, r) for o, r in zip(outs, ref)))
                ms = cs.device_ms(call)
                print(f"[time] reprojection {dn} BA {shape[0]}x{shape[1]}x{shape[2]} (K B = {k * b}) {t} threads: "
                      f"{ms:.4f} ms device, bitwise equal to the package's launch: {same[-1]} (the geometry "
                      f"picks {pick}) on {card}")
    return same


def bwd_tiles(dev, card):
    """Each batch tile of the level backward substitution, one for every
    level of a sweep, against the package's launches bit for bit, and the
    sweep's device time."""
    import torch

    import chip_smoke as cs
    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.sparse.level_kernels import (
        FWD_BLOCKS_PER_SM, bwd_subst_geometry, bwd_subst_rows, level_bwd_subst)

    same = []
    min_blocks = FWD_BLOCKS_PER_SM * _cuda.sm_count(dev.index)
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        fn = getattr(_cuda.lib(), f"th_level_bwd_subst_{_cuda.suffix(dtype)}")
        for label, make in (("PGO 256x128", lambda: cs.synthetic_problem(256, 128, dtype, dev)),
                            ("PGO 2048x8", lambda: cs.synthetic_problem(2048, 8, dtype, dev)),
                            ("grid {}x{}x{}".format(*cs.GRID), lambda: cs.grid_prob(dtype, dev))):
            prob = make()
            levels, lflat, x0, y = cs.timing_sweeps(cs.level_inputs(prob, *cs.plain_system(prob)[1:]))["bwd"]
            ref = x0.clone()
            level_bwd_subst(levels, lflat, ref, y)
            B, d, isz = lflat.shape[1], lflat.shape[-1], lflat.element_size()
            picks = [bwd_subst_geometry(t["dims"][0], t["dims"][1], B, d, isz, min_blocks)[0] for t in levels]
            work = x0.clone()
            ms = cs.device_ms(lambda: level_bwd_subst(levels, lflat, work, y))
            print(f"[time] level_bwd_subst {dn} {label} the geometry's tiles {picks}: {ms:.4f} ms device a sweep "
                  f"on {card}")
            for bt in BWD_TILES:
                out = x0.clone()

                def call():
                    t_b = min(bt, B)
                    for t in levels:
                        C, rl, ul = t["dims"]
                        rc = fn(lflat.data_ptr(), out.data_ptr(), y.data_ptr(), t["rec"].data_ptr(), C, rl, ul, B,
                                d, t_b, bwd_subst_rows(t_b, rl, d, isz), _cuda.stream_of(lflat))
                        if rc != 0:
                            raise RuntimeError(f"level_bwd_subst at bt {bt}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                same.append(torch.equal(out, ref))
                ms = cs.device_ms(call)
                print(f"[time] level_bwd_subst {dn} {label} bt {bt} every level: {ms:.4f} ms device a sweep, "
                      f"bitwise equal to the package's launches: {same[-1]} on {card}")
    return same


def rebuilt_sizes(dev, card, libs):
    """Each rebuilt block size of the whole-sweep kernels against the
    package kernel, bit for bit, and its device time."""
    import torch

    import chip_smoke as cs
    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.sparse.cholesky import factorize_levels, forward_sweep
    from theseus_tpu_torch.sparse.whole import (
        WHOLE_FACTOR_SMEM_MAX, get_tables, whole_bwd_subst, whole_factor, whole_factor_smem_bytes,
        whole_fwd_subst)

    same = []
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for n, b in WHOLE_SHAPES:
            prob, ata, atb = cs.whole_system(n, b, dtype, dev)
            ata, atb, sched = ata.contiguous(), atb.contiguous(), prob.builder.sched
            tb, d = get_tables(sched), ata.shape[-1]
            t_dev = tb.on(dev)
            smem_f = whole_factor_smem_bytes(sched, d, ata.element_size())
            smem_f = smem_f if smem_f <= WHOLE_FACTOR_SMEM_MAX else 0
            factor = factorize_levels(sched, ata)
            lflat = factor.blocks
            y = forward_sweep(sched, factor, atb[sched.on(dev)[0]])
            plans = {"whole_fwd_subst": (tb.fwd_plan(d, ata.element_size()), atb),
                     "whole_bwd_subst": (tb.bwd_plan(d, ata.element_size()), y)}
            p_dev = {k: plan.on(dev) for k, (plan, _) in plans.items()}
            refs = {"whole_factor": whole_factor(sched, ata).blocks,
                    "whole_fwd_subst": whole_fwd_subst(sched, factor, atb),
                    "whole_bwd_subst": whole_bwd_subst(sched, factor, y)}

            def sweep_args(kernel, out):
                plan, v = plans[kernel]
                return (lflat.data_ptr(), v.data_ptr(), p_dev[kernel]["rec"].data_ptr(),
                        p_dev[kernel]["table"].data_ptr(), plan.n_stages, plan.stage_ints, plan.buf_vals, tb.n, b,
                        d, int(plan.vec_smem), plan.smem, out.data_ptr(), _cuda.stream_of(lflat))

            args = {
                "whole_factor": lambda out: (ata.data_ptr(), t_dev["fact_rec"].data_ptr(), t_dev["fact_lvl"].data_ptr(),
                                             tb.n_levels, sched.sym.nnz_l + 1, tb.stage_ints, smem_f, b, d,
                                             out.data_ptr(), _cuda.stream_of(ata)),
                "whole_fwd_subst": lambda out: sweep_args("whole_fwd_subst", out),
                "whole_bwd_subst": lambda out: sweep_args("whole_bwd_subst", out),
            }
            for kernel, (_, _, _, default, sizes) in REBUILT.items():
                if (kernel, sizes[0]) not in libs:
                    continue
                for t in sizes:
                    fn = getattr(libs[kernel, t], f"th_{kernel}_{_cuda.suffix(dtype)}")
                    fn.argtypes = _cuda._SIGNATURES[f"th_{kernel}"]
                    out = torch.empty_like(refs[kernel])

                    def call():
                        rc = fn(*args[kernel](out))
                        if rc != 0:
                            raise RuntimeError(f"{kernel} at {t} threads: CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    same.append(torch.equal(out, refs[kernel]))
                    ms = cs.device_ms(call)
                    print(f"[time] {kernel} {dn} PGO {n}x{b} {t} threads: {ms:.4f} ms device, bitwise equal to "
                          f"the package kernel's ({default} threads): {same[-1]} on {card}")
    return same


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from theseus_tpu_torch import _cuda

    wanted = sys.argv[1:] or KERNELS
    unknown = set(wanted) - set(KERNELS)
    if unknown:
        print(f"unknown kernels {sorted(unknown)}; these have block sizes: {', '.join(KERNELS)}", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    _cuda.lib()
    builds = {(k, t): build(k, t) for k, spec in REBUILT.items() if k in wanted for t in spec[4]}
    libs = {}
    for (k, t), (out, proc) in builds.items():
        report, _ = proc.communicate()
        report = report.decode(errors="replace")
        (out / "build.log").write_text(report)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {k} at {t} threads:\n{report}")
        libs[k, t] = ctypes.CDLL(str(out / "lib.so"))
        for key, (r, sp) in sorted(ptxas_d6(report, REBUILT[k][2]).items()):
            print(f"[build] {k} {t} threads {key}: {r} registers, {sp} bytes spill stores (d = 6, worst variant)")
    print(f"[build] {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda", torch.cuda.current_device())
    same = ((between_sizes(dev, card) if "between_se3" in wanted else [])
            + (reprojection_sizes(dev, card) if "reprojection" in wanted else [])
            + (bwd_tiles(dev, card) if "level_bwd_subst" in wanted else [])
            + rebuilt_sizes(dev, card, libs))
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
