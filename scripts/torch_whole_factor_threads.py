"""Time theseus_tpu_torch's whole_factor kernel at 256, 512 and 1024 threads a block.

The kernel's block size is a constant, `WF_THREADS` in
`theseus_tpu_torch/csrc/whole_factor.cu`, which also sets its launch bounds
(and so the registers a thread may use: 64 at 1024 threads, 128 at 512,
255 at 256). This script compiles a copy of that source per block size
into `theseus_tpu_torch/_build/whole_factor_threads/`, loads each as a
library of its own and, on the PGO systems at 256 x 128 and 2048 x 8 in
float32 and float64:

- checks that each block size gives the package kernel's factor bit for
  bit (the arithmetic does not depend on the block size);
- times each one's device time per call (CUDA events, the queue held by a
  sleep kernel while the host enqueues the calls);
- reports ptxas's registers and spill stores for the d = 6 kernels.

Needs an NVIDIA Hopper GPU and nvcc. Run from the repository root:

    python3 scripts/torch_whole_factor_threads.py

It prints the card's name and power limit, then one line per build and
per measurement, and exits non-zero if a block size changed the factor.
"""

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

THREADS = (256, 512, 1024)
SHAPES = ((256, 128), (2048, 8))
CONSTANT = "constexpr int WF_THREADS = 1024;"
SLEEP_CYCLES = int(2e8)  # ~0.1 s at the H100's clock: longer than enqueueing the calls


def build(threads):
    """Start nvcc on a copy of whole_factor.cu with WF_THREADS = threads:
    (its build directory, the nvcc process)."""
    from theseus_tpu_torch import _cuda

    src = (_cuda.CSRC / "whole_factor.cu").read_text()
    if CONSTANT not in src:
        raise RuntimeError(f"whole_factor.cu no longer holds {CONSTANT!r}")
    out = _cuda.build_root() / "whole_factor_threads" / str(threads)
    out.mkdir(parents=True, exist_ok=True)
    (out / "whole_factor.cu").write_text(src.replace(CONSTANT, f"constexpr int WF_THREADS = {threads};"))
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC),
           str(out / "whole_factor.cu"), "-o", str(out / "lib.so")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def ptxas_d6(report):
    """{dtype: (registers, spill store bytes)} of the d = 6 kernels, the
    worse of the two variants."""
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
        if m and name and "whole_factor_kernel" in name and "Li6E" in name:
            key = "float32" if "kernelIfLi6E" in name else "float64"
            regs, sp = res.get(key, (0, 0))
            res[key] = (max(regs, int(m.group(1))), max(sp, spill))
    return res


def system(n, b, dtype, dev):
    from theseus_tpu_torch import config
    from theseus_tpu_torch.optim.normal import SparseNormalBuilder
    from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
    from theseus_tpu_torch.utils.examples.pose_graph import (
        build_pgo_objective, pose_values, synthetic_pose_graph)

    gt, edges, meas, init = synthetic_pose_graph(n, b, seed=0, dtype=dtype, device=dev)
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=dtype, device=dev)
    co = obj.compile()
    values = obj.default_values(pose_values(init))
    state, aux = co.pack(values, b), co.build_aux(values, b)
    bld = SparseNormalBuilder(co)
    with config.plain_path():
        ata, _ = assemble(bld.pattern, co.linearize_blocks(state, aux))
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    return bld.sched, ata


def device_ms(fn, reps=20):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the sleep outlasted the enqueueing
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
    raise RuntimeError("the host enqueued more slowly than the sleep kernel lasted, three times")


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.sparse.whole import (
        WHOLE_FACTOR_SMEM_MAX, get_tables, whole_factor, whole_factor_smem_bytes)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    _cuda.lib()
    builds = {t: build(t) for t in THREADS}
    libs, regs = {}, {}
    for t, (out, proc) in builds.items():
        report, _ = proc.communicate()
        report = report.decode(errors="replace")
        (out / "build.log").write_text(report)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at {t} threads:\n{report}")
        libs[t] = ctypes.CDLL(str(out / "lib.so"))
        regs[t] = ptxas_d6(report)
        for key, (r, sp) in sorted(regs[t].items()):
            print(f"[build] {t} threads {key}: {r} registers, {sp} bytes spill stores (d = 6, worse variant)")
    print(f"[build] {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    same_bits = []
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for n, b in SHAPES:
            sched, ata = system(n, b, dtype, dev)
            ref = whole_factor(sched, ata)
            tb, d = get_tables(sched), ata.shape[-1]
            rec, lvl = tb.on(dev)["fact_rec"], tb.on(dev)["fact_lvl"]
            smem = whole_factor_smem_bytes(sched, d, ata.element_size())
            smem = smem if smem <= WHOLE_FACTOR_SMEM_MAX else 0
            for t in THREADS:
                fn = getattr(libs[t], f"th_whole_factor_{_cuda.suffix(dtype)}")
                fn.argtypes = _cuda._SIGNATURES["th_whole_factor"]
                out = torch.empty_like(ref)

                def call():
                    rc = fn(ata.data_ptr(), rec.data_ptr(), lvl.data_ptr(), tb.n_levels, sched.sym.nnz_l + 1,
                            tb.stage_ints, smem, b, d, out.data_ptr(), _cuda.stream_of(ata))
                    if rc != 0:
                        raise RuntimeError(f"whole_factor at {t} threads: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                same = torch.equal(out, ref)
                ms = device_ms(call)
                same_bits.append(same)
                variant = "shared" if smem else "device"
                print(f"[time] whole_factor {dn} PGO {n}x{b} ({variant} memory) {t} threads: "
                      f"{ms:.4f} ms device, factor bitwise equal to the package kernel's: {same} on {card}")
    return 0 if all(same_bits) else 1


if __name__ == "__main__":
    sys.exit(main())
