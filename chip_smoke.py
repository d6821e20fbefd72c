#!/usr/bin/env python3
"""On-card check of theseus_tpu_torch: the batched SE3 pose-graph, bundle-adjustment, inverse-kinematics, 2-D SE2 pose-graph, motion-planning and tactile LM solves, block-Jacobi PCG, DCEM, Gaussian belief propagation and the learned-feature homography task on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA GPU, the CUDA
toolkit (nvcc) and g++:

    python3 chip_smoke.py

It imports neither jax nor theseus_tpu. Six main paths run through
`TheseusLayer.forward`: the PGO forward solve (256 poses x batch 128,
sparse linearization, level plan), the BA forward solve (128 cameras x 4000
points x batch 1, visibility 0.4: 204,800 Reprojection observations, Schur
linearization), the PGO training step (256 x 128: implicit backward
through the whole-sweep plan, `config.set_whole_sweep(True)`, and an SGD
step on a loop-closure weight) and the dense-tail PGO (a 16 x 16 grid of
poses at batch 128: 14 head levels through the level kernels, a 51-column
dense tail through one batched cholesky_ex; the tail phase prints both), the
robust BA training step (128 x 4000 x 1 float32, 5 % outliers, a Huber loss
whose log radius three implicit SGD steps learn, Schur linearization) and
the DLM training step (PGO 256 x 128 float32, level and whole-sweep plans).
Batch-sharded PGO 256 x 128 (`theseus_tpu_torch.parallel`: the forward and
the training step on two shards of one card), factor-sharded GBP, and the
seventeen example scripts of examples_torch and the seven paper-figure evaluations of evaluations_torch run too. A sixth, the AoS Between entry point `between_linearize_fused`, has no
caller in the package and is driven alone; a 3-D g2o file is read onto the
card and solved. Two more go through the default dense linearization: IK
serving (the 7-dof arm, an AutoDiffCostFunction over forward kinematics,
12 LM iterations from zero, float32, at batch 1, 256 and 4096) and PGO
64 x 16 (the JAX golden's problem), whose dense jacobian comes from the
Between kernel. The 2-D path: an SE2 pose graph of M3500's size (3500
poses, 5453 edges, batch 1; scripts/manhattan_g2o.py from a seed) read by
`read_2d_g2o` onto the card and solved on the sparse level plan at block
size 3, plus mini_2d.g2o and an SO3 rotation averaging on the dense
linearization. The planning path: GPMP2 motion planning (MotionPlanner,
utils/examples/motion_planning.py) at the reference's size, 128 x 128 maps
and 100 time steps (202 variables at block size 2), at batch 1 and 64 on
the sparse level plan. The tactile path: tactile pose estimation (the
Theseus paper's Fig. 4 workload, utils/examples/tactile_pose_estimation.py)
at 100 steps with moving-frame windows 10..40 step 5 (200 SE2 variables at
block size 3, 758 costs) at batch 64, its measurement and weight models
trained through the sparse level plan in every backward mode. Three solver
paths: PGO 256 x 128 on sparse_solver="pcg" (block-Jacobi PCG, the Between
and assembly kernels), DCEM on the 7-dof IK at batch 256 (no kernel of the
table), and Gaussian belief propagation on PGO 256 x 128 (the Between
kernel). In order:

1. fails fast without a CUDA device or outside a checkout;
2. builds the CUDA kernels from theseus_tpu_torch/csrc (nvcc, sm_90a, one
   process per source, in parallel) and the native symbolic analysis from
   theseus_tpu_torch/native (g++), and prints the build times and each
   kernel's registers and spills;
3. kernel phase: every kernel against its plain PyTorch twin on the card, at
   the shapes the main paths give it (PGO: Between at K=257, B=128, the
   assembly of both buckets, every etree level's (C, rl, ul), and the
   level backward substitution on each of the grid's 14 head levels,
   launched twice for the same bits; BA:
   Reprojection at K=204,800, B=1 and at 16 x 200 x batch 16, the mixed-dof
   assembly; the whole-sweep factor (against its per-column twin and the
   level kernels' factor, slot for slot, which must be equal bit for bit)
   and substitutions at PGO 256 x 128 and 2048 x 8, with the shared- or
   device-memory variant each shape takes; the AoS Between entry at K=257,
   B=128), in float32 and float64, each line with its deviation and
   tolerance; the assembly is launched twice at PGO 256 x 128, BA
   128 x 4000 x 1 and BA 16 x 200 x 16, the level forward substitution
   sweep and both whole sweeps at PGO 256 x 128 and 2048 x 8, the Between
   kernel at 257 x 128 and at a K B that is a multiple of no block
   (257 x 127), and the Reprojection kernel at BA 128 x 4000 x 1 and at a
   K B that is a multiple of no block (204,799), and each must give the
   same bits; the whole forward and backward sweeps must equal the level
   forward and backward sweeps on the same factor, exactly;
   BAL's 9-parameter cameras at BAL Dubrovnik-356's counts (356 x 226,730,
   1,255,268 observations, batch 1, intrinsics optimised): the intrinsics
   Reprojection kernel against its twin in float32 and float64, at K B and
   at a ragged K B - 1, each launched twice for the same bits, timed back to
   back, on the device and as its twin beside its bound; then the Schur LM
   solve (S one 9-dof block a camera) with its launch counts, 2 an
   iteration + 1 of the intrinsics kernel, none of the 6-dof one;
4. slice phases, one per path: the float32 forward with the launch counters
   reset just before and read just after; the converged plateau against the
   plain-twin float64 solve of the same problem on the card; the problem of
   the committed JAX float64 golden (PGO 64 x 16, BA 16 x 200 x 4); more
   requests on fresh inputs; for PGO one solve with the high-precision tier;
   the training path: three float32 implicit steps with the counters read
   around forward and backward(), the gradient against the float64
   plain-twin step and against the level-kernel step, and an unrolled
   float64 step at 64 x 16 against the twins; the grid with the dense
   tail: the float32 forward (counters, one cholesky_ex a factorization),
   its plateau against the float64 plain-twin solve, and one implicit
   training step against the float64 twins' gradient; the robust BA
   training step: three float32 implicit steps with the counters read
   around forward and backward() (Reprojection and assembly launches in
   the forward), forward and backward() ms, the gradient against the
   float64 plain twins and float64 kernels, and an unrolled float64 step at
   16 x 200 x 16 against the twins; the DLM step on both plans with the
   counters showing backward()'s two perturbed solves, its gradient against
   the float64 twins, and a float64 DLM step on BA 16 x 200 x 16 against
   the twins; `read_3d_g2o` of tests/fixtures/mini_3d.g2o solved on the card
   to below 1e-10; IK serving: ms per call and solves/s at each batch
   (fresh targets per call, each call ended by a sync), float32 against
   float64 per element at batch 256 (joint angles printed; held: of the
   targets float64 reaches, float32 reaches all but under 1 % to within
   1e-3), float64 on the card against the CPU, one LM iteration
   behind a sleep kernel (no host sync), synced stage times and a
   profiler window (idle share, kernels per iteration); dense PGO 64 x 16:
   the float32 forward with the counters around it (the Between kernel
   2 x 30 + 1 times), its plateau against the float64 plain-twin dense
   solve (2e-3) and the float64 dense solve against the JAX golden (1e-8);
   pgo2d: the M3500-sized SE2 graph written to a temporary directory and
   read onto the card, the assembly and level kernels against their twins
   at its d = 3, batch-1 shapes (f32, f64), the float32 forward with the
   counters around it (the assembly once an iteration, the three level
   kernels once a head level an iteration, one cholesky_ex for the dense
   tail), its plateau against the float64 plain-twin solve (2e-3), the
   float64 kernels against the twins (1e-8) and, on the 500-pose graph of
   tests/fixtures/pgo2d_500_jax_f64.npz, against the JAX golden (1e-8);
   the symbolic-analysis seconds, level count, tail, nnz_L, the LM
   iteration's ms and idle share, rows 2-4b's times and bounds at d = 3;
   mini_2d.g2o on the default dense linearization to below 1e-10; an SO3
   rotation averaging (SO3Family, from rand_so3 with no device named)
   against its float64 twin (2e-3); planning: maps from synthetic_maps
   (numpy seed 0), the assembly, level and whole-sweep kernels against their
   twins at the planner's d = 2 shapes at batch 1 and 64 (f32, f64, each
   launched twice for the same bits), the float32 forward at each batch
   with the counters around it (the assembly once an iteration, the level
   kernels once a head level an iteration), its plateau against the
   float64 plain twins (held on map 0, the batch printed: nonconvex),
   the float64 kernels, the float64 dense solve and the whole-sweep plan
   against the twins (1e-8), Dogleg against its float64 twin solve,
   compute_samples (16 samples, the backward sweep on the same y against
   its twin), compute_covariances of every 10th pose sparse against dense
   (1e-8), one learned-initialization step (its float32 gradient against
   the float64 twins'), ms per planning call and plans/s on fresh maps,
   the LM iteration's ms and idle share, rows 2-4b and 6-8 at d = 2;
   tactile: the schedule (levels, tail, nnz_L), the assembly and level
   kernels against their twins at its d = 3, batch-64 shapes, one float32
   implicit forward and its backward() with the counters around each (the
   assembly once a solve, the level kernels once a head level a solve, one
   cholesky_ex a solve for the dense tail), the loss gradient of every
   backward mode (unroll, implicit, truncated 5 and 10, dlm) in float64
   kernels against float64 twins and in float32 against float64 (cosine
   and norm-relative), the committed JAX float64 golden (T = 12, batch 4:
   poses, loss, gradients), ms per forward and backward() of every mode at
   3 and 10 inner iterations, three implicit SGD steps, the LM iteration's
   ms and idle share, rows 2-4b's times at d = 3 beside their bound and
   library call; pcg: the float32 forward with the counters around it
   (Between and assembly launches, no level or whole kernel), its plateau,
   ms per LM iteration beside the level and whole plans, the float64 PCG
   delta against the direct delta and the implicit gradient against the
   direct solve's; dcem: ms per iteration and the pose residuals, float64
   on the card against the CPU fed the same noise, one unroll gradient the
   same way; gbp: the float32 forward with the counters around it, ms per
   sweep and per outer iteration, the final error beside LM's, float64
   kernels against twins, compute_covariances on a tree against the sparse
   path's; homography: the learned-feature task (48 x 64 images, 4
   channels, patch stride 4, 12 LM iterations, truncated backward over 2,
   Adam 2e-3) trained 30 steps at batch 64 in float32 with the counters
   around the steps (no kernel of the table lies on this path), forward and
   backward() ms a step, the losses (finite, the least below the first),
   one profiled step's idle share, 3 steps each at patch stride 1 and in
   both autograd modes, the float32 step-0 gradient against float64's (as
   trained, reported; with fixed damping and no stopping tests, held), and
   the dense photometric fit at 60 x 80 (60 LM iterations) at batch 1
   (h_true, the JAX example's 0.2 assertion) and 64 (float32 corner error
   against float64's) with its ms per LM iteration; and in pgo2d the
   native (g++) symbolic analysis of the 3500-pose graph timed against its
   pure-Python twin, their tables equal; sharded: PGO 256 x 128 batch-sharded
   (theseus_tpu_torch/parallel) over make_mesh(devices=[card, card]) (and one
   shard per card where there are more), level and whole-sweep plans: the
   float32 and float64 forward with each shard's launches (each equal to
   the unsharded schedule's), the joined solution against the unsharded
   solve (1e-4 float32, 1e-10 float64), three float32 implicit training
   steps and one float64 step sharded against unsharded (loss and gradient
   1e-4 and 1e-9 relative), an unrolled float64 step at 64 x 16 (1e-9), the
   LM iteration's ms and idle share sharded and unsharded; gbp_sharded: GBP
   on 256 SE3 poses x batch 2, its 256 Between factors split in two (the
   prior whole), 20 sweeps, the delta against the unsharded one (float64
   1e-9, float32 1e-5 relative), a second unsharded solve bit for bit, the
   cross-device sums and the Between kernel's launches; examples: every
   examples_torch script's main() on the card at its committed
   examples/configs/*.yaml, its seconds, its last lines and its launches;
   evaluations: every evaluations_torch script's main() on the card at a
   cut of its sizes (vectorization at 16 and 64 poses x 16, all three
   arms, every arm's final float32 error within 1e-4 of the others' as a
   batch mean and within 2e-3 for each batch element; the
   PGO backward-mode sweep at 16 x 4, every float64 mode gradient against
   the same mode on the plain twins on the card within 1e-7 relative; the
   tactile sweep at 10 steps and 3 inner iterations; the autodiff
   ablation; the local-cost probe at batch 1 and 256; gbp_eval on its
   16-pose graph; gbp_hw_bench at 64 x 16; the vectorization window cut to
   (2, 8) iterations, the tactile learning run to 3 steps), their rows and
   seconds;
   in sharded, gbp_sharded, examples and evaluations every kernel launch
   of the path (the first of each input shape, up to 64 a kernel) is kept
   and held against its plain twin on the same inputs at the kernel
   tolerances;
5. timing phase: ms per LM iteration (marginal window, as bench.py) for the
   level kernels, the whole-sweep kernels and the plain twins (PGO 64 x 16,
   256 x 128 and 2048 x 8, the grid; BA 16 x 200 x 16 and 128 x 4000 x 1), ms per
   training step (whole against level), and each kernel against its twin
   and its library yardstick at the main-path shapes (CUDA events: calls
   back to back, and the device time alone with the queue prefilled by a
   sleep kernel), beside its bound (bytes over 3.35 TB/s or operations over
   67 TFLOP/s, the larger); the whole factor and both whole sweeps also at
   2048 x 8; the redesigned rows with the first designs' device times
   beside (rows 5, 8 and 4b, the last also over the grid); the level
   backward substitution also at 2048 x 8; the level factor and forward
   substitution per launch at
   their widest and deepest level and at the smallest shape (the launch
   floor); the grid's tail POTRF, tail elimination and factorization, and
   the level backward substitution sweep over its head levels beside its
   twin and the library's transposed solve with the grid's dense L;
6. profile phase: per path, synced stage times of one LM iteration and a
   torch.profiler window (device busy and idle share, launches, top
   kernels);
7. prints the seconds each phase took, one JSON line of kernel results, the
   card's name and power limit, and as the last line
   {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "pgo_64x16_jax_f64.npz"
BA_GOLDEN = ROOT / "tests" / "fixtures" / "ba_16x200_jax_f64.npz"
ITERS = 30  # enough for every solve here to sit on its plateau
BA_MAIN = (128, 4000, 1)  # cameras, points, batch: 204,800 observations
BA_SMALL = (16, 200, 16)
BA_VISIBILITY = 0.4
# BAL Dubrovnik problem-356-226730-pre's counts with BAL's 9-parameter
# cameras (f, k1, k2 optimised): cameras, points, observations, batch 1, the
# main path's shape (1,255,268 observations); its tracks drawn from their
# own seed (`synthetic_bal` tracks_seed), as a BAL file fixes its tracks
BAL_MAIN = (356, 226730, 1255268)
BAL_TRACKS_SEED = 356
BA_OPTS = dict(adaptive_damping=True, ellipsoidal_damping=True, linearization="schur")

# Kernel against twin, same inputs: max |kernel - twin| <= TOL * max(1, max |twin|).
# Default: float32 2e-5 (native sqrt/atan2 against torch's, FMA contraction
# and another summation order: about a hundred ulp of the output's scale);
# float64 1e-12 (the same formulas, only the rounding order differs).
# Reprojection takes the default: one branch-free chain with no atan2, so
# FMA contraction is the only difference; its outputs carry the focal
# length (~1e3), which the max(1, |twin|) scale absorbs.
# Between: its jlog coefficients (c, d of se3.jlog) are differences of O(theta^2)
# terms that cancel to O(theta^6) just above the derivative-branch switch
# (theta = 0.2 in float32), and the 256 x 128 initial state sits there. The
# float32 twin is itself 1.3e-3 (same scale) away from its float64 evaluation
# on the same inputs (measured on the CPU), so two float32 implementations
# may differ by that much: 2e-3. The same amplification (~1e4 eps) in
# float64 gives ~2e-12: 1e-10.
# The AoS Between entry runs the Between kernel: the same tolerance.
# The whole-sweep kernels are held against their twins over a whole sweep,
# where rounding-order differences compound through the etree levels: at
# most 2.0e-6 in float32, measured on an H100 80GB HBM3 at 700 W (2048 x 8),
# so 1e-4; float64 stays at the default (1.8e-15 measured).
KERNEL_TOL = {
    "float32": {"between_se3": 2e-3, "between_se3_aos": 2e-3, "whole_factor": 1e-4,
                "whole_fwd_subst": 1e-4, "whole_bwd_subst": 1e-4, "default": 2e-5},
    "float64": {"between_se3": 1e-10, "between_se3_aos": 1e-10, "default": 1e-12},
}
_SWEEP = "a whole sweep: rounding order compounds through the levels"
TOL_REASON = {
    "float32": {"between_se3": "f32 jlog cancellation near theta=0.2, atan2",
                "between_se3_aos": "f32 jlog cancellation near theta=0.2, atan2",
                "whole_factor": _SWEEP, "whole_fwd_subst": _SWEEP, "whole_bwd_subst": _SWEEP,
                "default": "summation order, FMA"},
    "float64": {"between_se3": "jlog cancellation at 1e4 eps", "between_se3_aos": "jlog cancellation at 1e4 eps",
                "default": "same formulas, rounding order"},
}
# Per-batch final error of a float32 kernel solve against a float64 solve of
# the same problem. float32 LM without the high-precision tier stalls within
# 3.4e-4 of the float64 plateau on these problems (the port's CPU twins,
# float32 against float64); 2e-3 leaves room for the card's rounding order.
PLATEAU_RTOL_F32 = 2e-3
# float64 kernels against the JAX float64 golden: converged float64 plateaus
PLATEAU_RTOL_F64 = 1e-8
# BA in float32 (errors and jacobians carry the focal length, 1e3) stalls
# further from its float64 plateau: 2.5e-3 at 16 x 200 x 16, 1.8e-3 at
# 16 x 200 x 4, 1.7e-3 at 32 x 400 x 2, 1.3e-3 at 64 x 800 x 1 (the port's
# CPU twins, float32 against float64); 1e-2 leaves room for the card's
# rounding order.
BA_PLATEAU_RTOL_F32 = 1e-2

KERNEL_INFO = {
    "between_se3": ("theseus_tpu_torch/csrc/between_se3.cu", "theseus_tpu/ops/pallas_between_soa.py:321"),
    "assemble_blocks": ("theseus_tpu_torch/csrc/assemble_blocks.cu", "theseus_tpu/sparse/pallas_assemble.py:124"),
    "level_factor": ("theseus_tpu_torch/csrc/level_factor.cu", "theseus_tpu/sparse/pallas_factorize.py:118"),
    "level_fwd_subst": ("theseus_tpu_torch/csrc/level_subst.cu", "theseus_tpu/sparse/pallas_factorize.py:260"),
    "level_bwd_subst": ("theseus_tpu_torch/csrc/level_subst.cu", "theseus_tpu/sparse/pallas_factorize.py:260"),
    "reprojection": ("theseus_tpu_torch/csrc/reprojection.cu", "theseus_tpu/ops/pallas_reprojection.py:171"),
    "whole_factor": ("theseus_tpu_torch/csrc/whole_factor.cu", "theseus_tpu/sparse/pallas_whole.py:319"),
    "whole_fwd_subst": ("theseus_tpu_torch/csrc/whole_subst.cu", "theseus_tpu/sparse/pallas_whole.py:508"),
    "whole_bwd_subst": ("theseus_tpu_torch/csrc/whole_subst.cu", "theseus_tpu/sparse/pallas_whole.py:523"),
    "between_se3_aos": ("theseus_tpu_torch/csrc/between_se3.cu", "theseus_tpu/ops/pallas_between.py:60"),
    "tail_update": ("theseus_tpu_torch/csrc/tail_update.cu", "none: theseus_tpu/sparse/cholesky.py _tail_* are jnp"),
    "reprojection_intr": ("theseus_tpu_torch/csrc/reprojection.cu",
                          "none: the JAX kernel (theseus_tpu/ops/pallas_reprojection.py) takes intrinsics as aux"),
}

# The training path (the JAX package's __graft_entry__ step): PGO 256 x 128
# float32, LM with adaptive damping, up to ITERS iterations, implicit
# backward, a loop-closure weight theta learned by SGD_STEPS steps of SGD.
TRAIN = (256, 128)
THETA0 = 1.0
SGD_STEPS = 3
SGD_FIRST_STEP = 0.05  # the learning rate is set so that the first step moves theta by this
# float32 kernel gradient against the float64 plain-twin gradient of the same
# step: float32 LM stalls within ~3e-4 of the float64 error plateau and the
# implicit gradient is taken at the stalled point, which moves it by up to
# ~1e-2 relative at 256 x 128 (8.2e-3 measured on an H100 80GB HBM3, 700 W).
# The level-kernel step sees the same float32 plateau. 5e-2.
GRAD_RTOL_F32 = 5e-2
# float64 unrolled step (64 x 16, 10 LM iterations), kernels against twins:
# the same arithmetic in another order through 10 differentiated iterations.
UNROLL = (64, 16, 10)
GRAD_RTOL_F64 = 1e-7
# The robust BA training path: BA_MAIN float32 with 5 % outliers, a Huber
# loss on every Reprojection cost, its log radius learned by BA_SGD_STEPS
# implicit steps of SGD (the first moves it by SGD_FIRST_STEP). Camera 0 is
# pinned at its ground truth (the gauge) and landmark 0 too, with weight
# BA_SCALE_PIN: the camera-0 gauge leaves the scene's scale free, and the
# implicit step's undamped system would be singular along it. (Pinning
# camera 1 instead, with the gauge's weight 1e4, fights the noisy
# observations: the undamped final step then moves the outer loss by 49 %
# and its float32 gradient sits 29 % from float64's from the same float64
# solution; with landmark 0 at 1e3 the step moves the loss by 2.7e-4 and
# float32 sits within 1.2e-4. BA_MAIN on an H100 80GB HBM3 at 700 W,
# scripts/torch_f32_gradients.py.)
BA_SCALE_PIN = 1e3
BA_OUTLIERS = 0.05
BA_LOG_RADIUS0 = 0.0
BA_SGD_STEPS = 3
# The float32 kernel gradient is held to the float64 plain twins' by the PGO
# rule, GRAD_RTOL_F32 (1.3e-3 measured at BA_MAIN on an H100 80GB HBM3 at
# 700 W, scripts/torch_f32_gradients.py), and the float64 kernels
# to the float64 twins by GRAD_RTOL_F64, as the unrolled steps.
# one unrolled float64 step on BA_SMALL, kernels against twins (GRAD_RTOL_F64)
BA_UNROLL_ITERS = 5
# DLM (direct loss minimization) training steps: the flagship's PGO TRAIN
# shape in float32 on the level and the whole-sweep plans, gradient against
# the float64 plain twins (GRAD_RTOL_F32: the float32 plateau, as for the
# implicit step; 3.1e-4 at 64 x 16 and 6.6e-4 at TRAIN on an H100 80GB HBM3
# at 700 W, scripts/torch_f32_gradients.py); and one
# float64 step on BA_SMALL, kernels against the twins on the CPU
# (GRAD_RTOL_F64). The gradient is a central difference over eps = 1e-2, so
# rounding-order differences of the solves reach it amplified by up to
# 1/(2 eps) = 50: the card twins' atomic index_add_ sums moved their own
# gradient by up to 1.3e-7 from run to run (an H100 80GB HBM3 at 700 W),
# while the kernels give the same bits each run and the CPU twins one order
# (4.7e-9 from the kernels on that card). BA's DLM
# runs in float64 only: its perturbed solves move the state by
# eps H^{-1} u ~ 1e-8 (H carries the focal length squared), below float32's
# resolution of the state, so a float32 BA DLM gradient is rounding noise
# (exactly 0 at BA_MAIN, -1.2e-4 against float64's 1.1e-6 at
# 128 x 1000 x 1, on that card, the same script).
DLM_BA_ITERS = 10
G2O = ROOT / "tests" / "fixtures" / "mini_3d.g2o"
# The 2-D pose graph: scripts/manhattan_g2o.py's graph of M3500's size (3500
# SE2 poses, 3499 odometry edges, 1954 loop closures) from PGO2D_SEED, read
# by read_2d_g2o onto the card, solved at batch 1 on the sparse level plan
# at block size 3; the JAX float64 golden's graph (PGO2D_GOLDEN, 500 poses)
# is regenerated from its seed. The float64 kernel solve must sit on its
# plateau after ITERS iterations: the error of iteration ITERS - 5 within
# PLATEAU_RTOL_F64 of the last.
MANHATTAN = ROOT / "scripts" / "manhattan_g2o.py"
PGO2D_POSES = 3500
PGO2D_SEED = 0
PGO2D_GOLDEN = ROOT / "tests" / "fixtures" / "pgo2d_500_jax_f64.npz"
G2O_2D = ROOT / "tests" / "fixtures" / "mini_2d.g2o"
# mini_2d.g2o's vertices agree exactly with its edges: poses 1 and 2 are
# moved off them by this tangent before the solve (tests/test_torch_g2o_2d.py)
MINI_2D_SHIFT = (0.1, -0.05, 0.05)
# rotation averaging on SO3 (dense): SO3_ROT rotations at batch SO3_BATCH, a
# chain and the (i, i + 2) edges, measurement noise 0.05 rad, init noise 0.3
SO3_ROT, SO3_BATCH = 20, 16
WHOLE_SHAPES = ((256, 128), (2048, 8))
# the dense-tail path: a 16 x 16 grid PGO (256 poses) at batch 128; its
# symbolic analysis folds the last 51 columns into one dense supernode
GRID = (16, 16, 128)
# the dense tail's external update at the benchmark's shape: the
# sphere2500-sized 50 x 50 snake grid (portbench) at batch 64, a 123-column
# tail; the plain twin, which gathers 22.6 GB in float32 at this batch, is
# held against the kernel in slices of TAIL_UPDATE_SLICE batch elements
TAIL_UPDATE_GRID = (50, 50, 64)
TAIL_UPDATE_SLICE = 8
# device ms of the first designs of the redesigned rows 5, 8 and 4b
# (PERF.md, kernel table, the previous design's last measurement: NVIDIA
# H100 80GB HBM3, 700 W; reprojection at BA 128 x 4000 x 1, the others at
# PGO 256 x 128, level_bwd_subst also at 2048 x 8 (the parent tree in
# scripts/torch_ab.py's A/B) and over the grid's head levels, one sweep),
# printed beside this run's
FIRST_DESIGN_DEVICE_MS = {"reprojection": 0.0416, "whole_bwd_subst": 0.0528, "level_bwd_subst": 0.0649,
                          "level_bwd_subst 2048x8": 0.0777, "level_bwd_subst grid": 0.2731}
# The IK serving path (utils/examples/inverse_kinematics.py): the 7-dof arm
# at these batches, IK_REQUESTS timed requests each on fresh targets.
IK_BATCHES = (1, 256, 4096)
IK_REQUESTS = 3
# float32 against float64 at IK_CHECK_BATCH, per batch element. The arm is
# redundant (7 joints, a 6-dof pose): AtA is 7 x 7 of rank 6, its null
# direction bounded only by the damping (down to 1e-7), and float32 rounding
# gives each step a null-space part of order eps_f32 / damping, so float32
# ends at another point of the solution set: joint angles more than 1e-2
# apart in 27 of 256 elements, the rest within 9.5e-3 rad (an H100 80GB
# HBM3 at 700 W); the JAX package's float32 solve does the same
# (tests/test_torch_kin.py). Joint angles are printed, not held. Held: of
# the elements the float64 solve brings to their target (pose residual
# norm below IK_SOLVED), float32 brings all but under IK_MISS_SHARE there
# too (residual below IK_TASK_TOL; on that card every one of the 247, the
# worst at 7.7e-7). Elements that 12 iterations leave unsolved in either
# precision follow each precision's own LM trajectory and are only
# counted.
IK_CHECK_BATCH = 256
IK_BASIN = 1e-2
IK_SOLVED = 1e-6
IK_TASK_TOL = 1e-3
IK_MISS_SHARE = 0.01
# float64 on the card against the CPU, first IK_CPU_BATCH elements: the
# same float64 arithmetic in another order through 12 LM iterations
IK_CPU_BATCH = 4
IK_F64_TOL = 1e-9
# the card's peaks for the bound: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (H100 SXM data sheet, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# approximate arithmetic per (edge, batch) of the Between linearization
# (two composes, log, jlog, the 6 x 6 adjoint product) and per (observation,
# batch) of the Reprojection linearization: operation counts for the bound,
# which both kernels exceed by far in bytes
BETWEEN_FLOPS = 800
REPROJECTION_FLOPS = 200
# the same with the intrinsics optimised (reprojection_intr_kernel): the
# chain above and jintr, a hand count of about 145
REPROJECTION_INTR_FLOPS = 150
# torch.cuda._sleep spins for a number of SM clock cycles; the H100's boost
# clock is at most 1.98 GHz, so this many cycles last at least one second
SLEEP_CYCLES_PER_S = 2.0e9
# The planning path (utils/examples/motion_planning.py, GPMP2): the size of
# the reference's motion-planning experiment, 128 x 128 maps (cell 0.1 m,
# origin 0) and 100 time steps over 10 s (101 Point2 poses and 101
# Vector(2) velocities: 202 variables, block size 2), Qc^-1 = I, boundary
# weight 100, collision weight 20, epsilon_dist 0.8 (safety distance 0.4 +
# robot radius 0.4); maps from synthetic_maps (6 boxes, 4 discs, numpy seed
# PLAN_SEED, start and goal kept free); LM with adaptive damping, 50
# iterations, sparse, at each of PLAN_BATCHES through TheseusLayer.forward.
PLAN_MAP, PLAN_CELL, PLAN_STEPS, PLAN_TIME = 128, 0.1, 100, 10.0
PLAN_EPS, PLAN_CW, PLAN_ITERS, PLAN_SEED = 0.8, 20.0, 50, 0
PLAN_BATCHES = (1, 64)
PLAN_REQUESTS = 3  # timed planning calls at each batch, fresh maps each
PLAN_SAMPLES = 16  # compute_samples at the largest batch
PLAN_COV_EVERY = 10  # compute_covariances of every 10th pose
# The float32 plateau. The planner's problem is nonconvex (the collision
# hinge over a bilinear SDF) and ill-conditioned (cond(AtA) 2.5e5-1e7 at the
# straight line: the GP prior's 12/dt^3 = 1.2e4 against the weak modes).
# After 50 iterations a trajectory caught against an obstacle still creeps,
# and float32's rounding sends it into another local minimum, lower or
# higher: on these 64 maps float32 sat up to 8.0x from float64's final error,
# and 4.0e-2 on an element whose float64 error had settled to 1e-6 over its
# last 10 iterations (an NVIDIA H100 80GB HBM3 at 700 W; the port's CPU
# twins do the same). PLATEAU_RTOL_F32 is held on map 0 (the batch-1
# problem, converged in a few iterations); the batch is printed.
# One outer step of examples/motion_planning_learned.py: the initial-
# trajectory model (random weights from a torch.Generator) at batch
# PLAN_LEARN_BATCH, LM with adaptive damping unrolled through
# PLAN_LEARN_ITERS iterations on the sparse plan, loss the mean final
# error. From the model's initialization (offsets up to 2.9 m, error 1.5e6)
# the float32 steps carry the conditioning above: the float32 gradient sat
# 0.131 (norm-relative) from float64's, cosine 0.991 (the port's CPU twins,
# 16 maps); with fixed damping, as the JAX example has it, float32 and
# float64 part ways entirely (cosine -0.33), so the step takes adaptive
# damping. Held: norm-relative PLAN_GRAD_RTOL_F32 and cosine
# PLAN_GRAD_COS_F32; float64 kernels against float64 twins GRAD_RTOL_F64.
PLAN_LEARN_BATCH, PLAN_LEARN_ITERS = 16, 3
PLAN_GRAD_RTOL_F32, PLAN_GRAD_COS_F32 = 0.5, 0.9
# The tactile path (utils/examples/tactile_pose_estimation.py, the Theseus
# paper's Fig. 4 workload): T = TAC_STEPS steps with moving-frame windows
# TAC_WINDOWS (min, max, step; taken to be the reference's tactile settings,
# whose config is not in this repository): 200 SE2 variables (d = 3) and
# 758 costs; the episode from synthetic_push (numpy seed TAC_SEED) at batch
# TAC_BATCH with features of dim TAC_FEATURES; LM on the sparse plan, inner
# iterations TAC_INNER, the backward modes TAC_MODES (mode, backward
# iterations), TAC_SGD_STEPS implicit SGD steps at TAC_LR. The problem is
# nonsmooth (the contact hinge), so the float32 gradient is held to
# float64's by cosine and norm-relative error: at 3 inner iterations
# norm-rel 1.416e-3 (unroll, truncated) and 1.310e-4 (implicit), 1.952e-4
# (dlm), cosine at least 0.99999914, on an NVIDIA H100 80GB HBM3 at 700 W:
# TAC_GRAD_RTOL_F32 1e-2 and TAC_GRAD_COS_F32 0.9999. Float64 kernels
# against float64 twins GRAD_RTOL_F64 (8.6e-12 measured; DLM 2.1e-8: its
# reference runs the twins on the CPU, as the card twins' atomic sums move
# a DLM gradient by ~1e-7 between runs).
TAC_STEPS, TAC_WINDOWS, TAC_BATCH, TAC_FEATURES, TAC_SEED = 100, (10, 40, 5), 64, 8, 0
TAC_INNER = (3, 10)
TAC_MODES = (("unroll", 5), ("implicit", 5), ("truncated", 5), ("truncated", 10), ("dlm", 5))
TAC_SGD_STEPS, TAC_LR = 3, 1e-3
TAC_GRAD_RTOL_F32, TAC_GRAD_COS_F32 = 1e-2, 0.9999
TACTILE_GOLDEN = ROOT / "tests" / "fixtures" / "tactile_12x4_jax_f64.npz"
# The PCG path: PGO TRAIN (256 x 128) on sparse_solver="pcg" with
# PCG_ITERS CG iterations (the JAX default). Held in float64: the PCG delta
# against the direct delta on the same normal system at PCG_CHECK_ITERS
# (rtol 1e-6, atol 1e-8, tests/optim/test_pcg.py's tolerances) under LM
# damping PCG_CHECK_DAMPING (on this 256-pose chain CG at 200 iterations is
# 18 % off undamped and 1.4e-3 off at damping 1e-3: the port's CPU, B = 2;
# printed), and the implicit gradient against the direct solve's, rtol 1e-3,
# at PCG_GRAD_ITERS (the final undamped step and its adjoint: 85 % off at
# 100 iterations, 2.1e-2 at 400, 1.4e-4 at 800 on the same CPU run; at
# batch 128 on an H100 80GB HBM3 at 700 W 48 % off at 100 and 2.3e-3 at
# 800; the gradient at PCG_ITERS is printed).
PCG_ITERS, PCG_CHECK_ITERS, PCG_CHECK_DAMPING, PCG_GRAD_ITERS = 100, 200, 1e-2, 1600
# The DCEM path: the 7-dof IK (utils/examples/inverse_kinematics.py) at
# batch DCEM_BATCH, DCEM's defaults (100 samples, 5 elites, temp 1, sigma
# 1), DCEM_ITERS iterations from zero; float64 on the card against the CPU
# fed the same noise (a CPU generator seeded DCEM_SEED) at DCEM_CHECK
# (batch, iterations), and one unroll gradient with respect to the targets
# at DCEM_GRAD (batch, iterations), each 1e-8 / GRAD_RTOL_F64.
DCEM_BATCH, DCEM_ITERS, DCEM_SEED = 256, 50, 0
DCEM_CHECK, DCEM_GRAD = (256, 50), (16, 10)
DCEM_F64_TOL = 1e-8
# The GBP path: GaussianBeliefPropagation on PGO TRAIN, GBP_MSG_ITERS sweeps
# a linearization at message damping GBP_DAMPING, GBP_OUTER outer
# iterations; float64 kernels against twins 1e-10; compute_covariances on
# the chain without loop closures GBP_TREE (poses, batch), where GBP is
# exact with enough sweeps (GBP_TREE_SWEEPS, no message damping, no ridge:
# a ridge of 1e-12 moves the far end's covariances by 3.2e-8, on the card
# and on the CPU alike), against the sparse path's, PLATEAU_RTOL_F64.
GBP_MSG_ITERS, GBP_DAMPING, GBP_OUTER = 40, 0.3, 20
GBP_TREE, GBP_TREE_SWEEPS = (64, 16), 70
# The homography path (utils/examples/homography.py): the learned-feature
# task at the JAX example's widths, 48 x 64 images, 4 feature channels,
# patch stride 4 (468 points, 1872 residual rows), 12 LM iterations with
# adaptive damping, a backward truncated to the last 2, Adam at 2e-3, at
# batch 64 (the config's batch of 4 raised to a training run's) for the
# config's 30 steps; then HOMOG_EXTRA steps each at patch stride 1 and in
# both autograd modes. The float32 gradient at step 0 against the float64
# gradient of the same step on the card: reported as trained, held
# (HOMOG_GRAD_RTOL, HOMOG_GRAD_COS) with fixed damping and no stopping
# tests (norm-relative error at batch 64 on an H100 80GB HBM3 at 700 W:
# 1.3e-1, cosine 0.993, as trained; on a CPU at batch 32: 4.5e-1 as
# trained, 9.0e-6 with fixed damping and no stopping tests). The dense photometric fit at 60 x 80, 60 LM
# iterations, batch 1 (the JAX example's h_true; its 0.2 entrywise
# assertion) and 64 (RandomGeoAug homographies; the float32 corner error
# against the float64 solve's, FIT_CORNER_TOL pixels), and its ms per LM
# iteration in the window (t(N + K) - t(N)) / K, FIT_WINDOW = (N, K).
HOMOG_HW, HOMOG_CHANNELS, HOMOG_STRIDE, HOMOG_ITERS, HOMOG_BWD = (48, 64), 4, 4, 12, 2
HOMOG_BATCH, HOMOG_STEPS, HOMOG_EXTRA, HOMOG_LR, HOMOG_SEED = 64, 30, 3, 2e-3, 0
HOMOG_GRAD_RTOL, HOMOG_GRAD_COS = 1e-3, 0.99999
FIT_HW, FIT_ITERS, FIT_BATCHES, FIT_WINDOW = (60, 80), 60, (1, 64), (10, 20)
FIT_H_TRUE = (1.02, 0.01, 1.5, -0.02, 0.98, -1.0, 1e-4, -5e-5)
FIT_ASSERT, FIT_CORNER_TOL = 0.2, 0.05
# The batch-sharded path (theseus_tpu_torch/parallel): PGO SHARD_PGO, the
# README flagship's shape, on make_mesh(devices=[card, card]) (two shards of
# 64; with more cards also one shard per card), level and whole-sweep
# plans, ITERS LM iterations. The joined solution against the unsharded
# solve: SHARD_TOL_F32 absolute in float32 (tests/parallel/test_sharding.py's
# tolerance between its sharded and unsharded solves), SHARD_TOL_F64 in
# float64; the training step's loss and gradient SHARD_GRAD_RTOL_F32 and
# SHARD_GRAD_RTOL_F64 relative; the idle shares over SHARD_PROFILE_ITERS
# LM iterations under the profiler. With one shard per card (4 cards: 32 a
# shard) float32 rounds otherwise than at 64 or 128 a shard: four shards
# of 32 sat 3.612e-3 from the unsharded state and 3.3e-4 in final error,
# on one card and on four cards (four H100 80GB HBM3 at 700 W; float64
# 0.0); so the per-card mesh is held against the same shards on one card
# (the device placement: SHARD_TOL_F32 and SHARD_GRAD_RTOL_F32, bit
# equality printed), by PLATEAU_RTOL_F32 against the unsharded plateau,
# and in float64 by SHARD_TOL_F64.
SHARD_PGO = (256, 128)
SHARD_TOL_F32, SHARD_TOL_F64 = 1e-4, 1e-10
SHARD_GRAD_RTOL_F32, SHARD_GRAD_RTOL_F64 = 1e-4, 1e-9
SHARD_PROFILE_ITERS = 3
# GBP factor sharding at scripts/dryrun_gbp_shard.py's size: GBP_SHARD
# (poses, batch), the chain plus one closure, GBP_SHARD_SWEEPS sweeps at
# message damping GBP_DAMPING; the sharded delta against the unsharded one,
# relative to its largest entry: GBP_SHARD_TOL_F64 in float64,
# GBP_SHARD_TOL_F32 in float32. The belief sums add in a fixed order (no
# variable twice in one index_add, `GBPNormalBuilder.scatter_plan`), so two
# unsharded solves must give the same bits, and the two-way split groups a
# variable's terms otherwise only where three of them meet across chunks
# (the closure's pose n/2): 5.3e-6 on the CPU in float32.
GBP_SHARD, GBP_SHARD_SWEEPS = (256, 2), 20
GBP_SHARD_TOL_F64, GBP_SHARD_TOL_F32 = 1e-9, 1e-5


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
    """A problem on the card: objective, layer, packed state and aux."""

    def __init__(self, obj, inputs, iters=ITERS, **opt_kwargs):
        import theseus_tpu_torch as tt

        self.obj = obj
        self.inputs = inputs
        opt_kwargs.setdefault("adaptive_damping", True)
        opt_kwargs.setdefault("linearization", "sparse")
        self.layer = tt.TheseusLayer(
            tt.LevenbergMarquardt(obj, max_iterations=iters, **opt_kwargs)
        )
        self.opt = self.layer.optimizer
        self.co = obj.compile()
        values = obj.default_values(inputs)
        self.batch = self.co.resolve_batch_size(values)
        self.state = self.co.pack(values, self.batch)
        self.aux = self.co.build_aux(values, self.batch)
        t0 = time.perf_counter()
        self.builder = self.opt.normal_builder
        self.builder_s = time.perf_counter() - t0  # block pattern, symbolic analysis, schedule


def synthetic_problem(n, b, dtype, dev, seed=0, extra_loop_closures=True, **opt_kwargs):
    from theseus_tpu_torch.utils.examples.pose_graph import (
        build_pgo_objective, pose_values, synthetic_pose_graph)

    gt, edges, meas, init = synthetic_pose_graph(n, b, seed=seed, dtype=dtype, device=dev,
                                                 extra_loop_closures=extra_loop_closures)
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=dtype, device=dev)
    return Problem(obj, pose_values(init), **opt_kwargs)


def grid_prob(dtype, dev):
    obj, inputs, _ = grid_problem(*GRID, dtype, dev)
    return Problem(obj, inputs)


def golden_problem(dtype, dev, **opt_kwargs):
    from theseus_tpu_torch.utils.convert import load_problem_npz

    obj, inputs = load_problem_npz(GOLDEN, dtype=dtype, device=dev)
    return Problem(obj, inputs, **opt_kwargs)


def golden_errors(path=GOLDEN):
    import numpy as np

    with np.load(path) as f:
        return np.array(f["final_err"]), int(f["n_iters"])


def ba_problem(cams, pts, batch, dtype, dev, seed=0):
    from theseus_tpu_torch.utils.examples.bundle_adjustment import (
        ba_values, build_ba_objective, synthetic_ba)

    prob = synthetic_ba(cams, pts, batch=batch, seed=seed, visibility=BA_VISIBILITY, dtype=dtype, device=dev)
    obj, _, _ = build_ba_objective(prob, dtype=dtype, device=dev)
    return Problem(obj, ba_values(prob), **BA_OPTS)


def ba_golden_problem(dtype, dev):
    from theseus_tpu_torch.utils.convert import load_ba_npz
    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective

    prob = load_ba_npz(BA_GOLDEN, dtype=dtype, device=dev)
    obj, _, _ = build_ba_objective(prob, dtype=dtype, device=dev)
    return Problem(obj, ba_values(prob), **BA_OPTS)


def bal_parts(dtype, dev):
    """(BAProblem, objective, landmarks) of BAL_MAIN with the intrinsics
    optimised."""
    from theseus_tpu_torch.utils.examples.bundle_adjustment import build_ba_objective, synthetic_bal

    prob = synthetic_bal(*BAL_MAIN, seed=0, tracks_seed=BAL_TRACKS_SEED, dtype=dtype, device=dev)
    obj, _, pts, _ = build_ba_objective(prob, dtype=dtype, device=dev, optimize_intrinsics=True)
    return prob, obj, pts


def bal_operands(dtype, dev):
    """The BAL_MAIN Reprojection bucket's gathered (pose, point, intrinsics)
    and its feature, from the packed state as the solver gathers them; no
    normal-equation builder."""
    from types import SimpleNamespace

    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values

    prob, obj, _ = bal_parts(dtype, dev)
    co = obj.compile()
    values = obj.default_values(ba_values(prob, optimize_intrinsics=True))
    b = co.resolve_batch_size(values)
    return reprojection_operands(SimpleNamespace(co=co, state=co.pack(values, b), aux=co.build_aux(values, b)))


def reprojection_operands(prob):
    """The Reprojection bucket's gathered (pose, point[, intrinsics]) and
    its aux, as the solver hands them to the kernel."""
    from theseus_tpu_torch.embodied import Reprojection

    for bi, bk in enumerate(prob.co.buckets):
        if isinstance(bk.template, Reprojection):
            return prob.co.gather_optim(bk, prob.state) + prob.aux[bi][0]
    raise CheckFailed("no Reprojection bucket")


def padded_blocks(prob):
    """Plain-twin linearization of every bucket, jacobians padded to d."""
    from theseus_tpu_torch import config
    from theseus_tpu_torch.sparse.assemble import _pad_jac

    d = prob.builder.pattern.d
    with config.plain_path():
        blocks = prob.co.linearize_blocks(prob.state, prob.aux)
    return [([_pad_jac(j, d) for j in jacs], err) for jacs, err in blocks]


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
    from theseus_tpu_torch import native

    t0 = time.perf_counter()
    npath = native.build()
    native.lib()
    print(f"[build] native symbolic analysis {npath.relative_to(ROOT)} ready in {time.perf_counter() - t0:.2f} s "
          f"(g++ time {native.build_seconds:.2f} s; 0 means a cached build was reused)")
    # the -Xptxas -v report for the d = 6 instantiations the PGO path runs
    log = _cuda.build_log().splitlines()
    for i, line in enumerate(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m:
            continue
        name = m.group(1)
        if not ("between_se3" in name or "reprojection" in name or "Li6E" in name):
            continue
        kind = next(k for k in ("between_se3", "reprojection_intr", "reprojection", "assemble", "whole_factor", "whole_fwd",
                                "whole_bwd", "level_factor", "fwd_subst", "bwd_subst", "tail_update") if k in name)
        if kind in ("whole_fwd", "whole_bwd", "whole_factor"):  # shared memory or device memory
            kind += " smem" if "Lb1E" in name else " global"
        dt = "f64" if "kernelId" in name else "f32"
        info = " ".join(l.strip() for l in log[i + 1 : i + 5])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores", info)
        print(f"[build] {kind:<17} {dt}: {regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spilled")


# ---------------------------------------------------------------------------
# phase 3: kernels against twins at the 256 x 128 shapes
# ---------------------------------------------------------------------------
def _twin_dev(name, dtype_name, got, want):
    """(max |kernel - twin|, the same over max(1, max |twin|)) over the
    outputs (a tensor or a sequence of them); fails on a non-finite kernel
    output."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(got, want):
        check(bool(torch.isfinite(g).all()), f"{name} {dtype_name}: non-finite kernel output")
        scale = max(1.0, float(w.abs().max()))
        worst_abs = max(worst_abs, float((g - w).abs().max()))
        worst_rel = max(worst_rel, float((g - w).abs().max()) / scale)
    return worst_abs, worst_rel


def _dev_report(name, dtype_name, got, want, shape_note=""):
    worst_abs, worst_rel = _twin_dev(name, dtype_name, got, want)
    tol = KERNEL_TOL[dtype_name].get(name, KERNEL_TOL[dtype_name]["default"])
    reason = TOL_REASON[dtype_name].get(name, TOL_REASON[dtype_name]["default"])
    verdict = "ok" if worst_rel <= tol else "FAIL"
    print(f"[kernel] {name:<15} {dtype_name} {shape_note:<26} max_abs={worst_abs:.3e} "
          f"max_rel(to max(1,|twin|))={worst_rel:.3e} tol={tol:.0e} ({reason}) {verdict}")
    check(worst_rel <= tol, f"{name} {dtype_name}: kernel deviates from its twin by {worst_rel:.3e} > {tol}")
    return worst_abs


def _repeatable(name, fn, note):
    """Two launches of fn on the same inputs: the outputs must be equal bit
    for bit (the kernel sums in a fixed order and uses no atomics)."""
    import torch

    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[kernel] {name:<15} {note:<34} two launches bitwise equal: {same}")
    check(same, f"{name} {note}: two launches on the same inputs differ")
    return first


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
        got = _repeatable("between_se3", lambda: between_linearize(v1, v2, meas), f"{dn} PGO 256x128")
        e = _dev_report("between_se3", dn, got, between_linearize_plain(v1, v2, meas), note)
        # a K B that is a multiple of no block size (257 x 127 = 32,639)
        r1, r2, rm = (t[:, :127] for t in (v1, v2, meas))
        note = f"K={r1.shape[0]} B={r1.shape[1]} (ragged)"
        got = _repeatable("between_se3", lambda: between_linearize(r1, r2, rm), f"{dn} ragged K B")
        e = max(e, _dev_report("between_se3", dn, got, between_linearize_plain(r1, r2, rm), note))
        max_abs.setdefault("between_se3", {})[dn] = e

        _, ata, lflat, y, x, b_perm = plain_system(prob)
        padded = padded_blocks(prob)
        note = "buckets K=" + ",".join(str(err.shape[0]) for _, err in padded)
        got = _repeatable("assemble_blocks", lambda: assemble_blocks(prob.builder.pattern, padded),
                          f"{dn} PGO 256x128")
        e = _dev_report("assemble_blocks", dn, got, assemble_blocks_plain(prob.builder.pattern, padded), note)
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
        # the grid's head levels: columns of 5 to 15 rows, batch tiles of 1 to 32
        g_prob = grid_prob(dtype, dev)
        for li, (_, _, bwd) in enumerate(level_inputs(g_prob, *plain_system(g_prob)[1:])):
            note = "grid level {:2d} C={} rl={}".format(li, *bwd[0].shape[:2])
            got = _repeatable("level_bwd_subst", lambda: [level_bwd_subst(*bwd)], f"{dn} {note}")
            worst["level_bwd_subst"] = max(worst["level_bwd_subst"], _dev_report(
                "level_bwd_subst", dn, got, [level_bwd_subst_plain(*bwd)], note))
        for k, v in worst.items():
            max_abs.setdefault(k, {})[dn] = v
    torch.cuda.synchronize()
    print(f"[kernel] 256x128 levels (C, rl, ul): {shapes['float32']}")
    return max_abs


def phase_ba_kernels(dev, max_abs):
    """Reprojection at the BA main-path shape and at 16 x 200 x 16, and the
    mixed-dof (camera 6, point 3 padded to 6) assembly at both: split lists
    with B = 1 and with 1 < B < 32, each launched twice."""
    import torch

    from theseus_tpu_torch.ops.reprojection import reprojection_linearize, reprojection_linearize_plain
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain

    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        worst = 0.0
        for shape in (BA_MAIN, BA_SMALL):
            prob = ba_problem(*shape, dtype, dev)
            ops = reprojection_operands(prob)
            note = f"K={ops[0].shape[0]} B={ops[0].shape[1]}"
            if shape == BA_MAIN:
                got = _repeatable("reprojection", lambda: reprojection_linearize(*ops), f"{dn} BA {note}")
                # one item fewer: a K B that is a multiple of no block size
                # (stacked aux lose the item too, shared aux keep their shape)
                cut = [t[:-1] if t.dim() >= 3 else t for t in ops]
                cut_note = f"K={cut[0].shape[0]} B={cut[0].shape[1]} (ragged)"
                ragged = _repeatable("reprojection", lambda: reprojection_linearize(*cut), f"{dn} BA {cut_note}")
                worst = max(worst, _dev_report("reprojection", dn, ragged, reprojection_linearize_plain(*cut),
                                               cut_note))
            else:
                got = reprojection_linearize(*ops)
            worst = max(worst, _dev_report("reprojection", dn, got, reprojection_linearize_plain(*ops), note))
            padded = padded_blocks(prob)
            pattern = prob.builder.pattern
            label = "BA {}x{}x{}".format(*shape)
            note = f"{label} split {len(pattern.asm_tables.split)}"
            got = _repeatable("assemble_blocks", lambda: assemble_blocks(pattern, padded), f"{dn} {note}")
            e = _dev_report("assemble_blocks", dn, got, assemble_blocks_plain(pattern, padded), note)
            max_abs["assemble_blocks"][dn] = max(max_abs["assemble_blocks"][dn], e)
        max_abs.setdefault("reprojection", {})[dn] = worst
    torch.cuda.synchronize()
    return max_abs


def whole_system(n, b, dtype, dev):
    """The LM-damped PGO system of an n x b problem, assembled by the plain
    twins: the inputs of the whole-sweep kernels."""
    from theseus_tpu_torch import config
    from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble

    prob = synthetic_problem(n, b, dtype, dev)
    bld = prob.builder
    with config.plain_path():
        blocks = prob.co.linearize_blocks(prob.state, prob.aux)
        ata, atb = assemble(bld.pattern, blocks)
        ata = apply_block_damping(bld.pattern, ata, 1e-3, False, 1e-8)
    return prob, ata, atb


def phase_whole_kernels(dev, max_abs):
    """Rows 6-8 at PGO 256 x 128 and 2048 x 8, and row 9 at K=257, B=128:
    the factor against its per-column twin and against the level kernels'
    factor slot for slot (slot 0 zero); each substitution against its twin
    on the twin's factor. At both shapes also the level forward substitution
    sweep: two launches bitwise equal, and each level against its twin.
    Returns max_abs and the ms of the float32 twin calls at 2048 x 8 (seconds
    each: the timing phase reports these rather than run them again)."""
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.ops.between_se3 import between_linearize_fused, between_linearize_plain
    from theseus_tpu_torch.sparse.cholesky import backward_sweep, factorize_levels, forward_sweep
    from theseus_tpu_torch.sparse.level_kernels import level_fwd_subst, level_fwd_subst_plain
    from theseus_tpu_torch.sparse.whole import (
        get_tables, whole_bwd_subst, whole_factor, whole_factor_smem_bytes, whole_factor_variant,
        whole_fwd_subst)

    twin_ms = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for n, b in WHOLE_SHAPES:
            prob, ata, atb = whole_system(n, b, dtype, dev)
            sched = prob.builder.sched
            note = f"PGO {n}x{b} nnz_l={sched.sym.nnz_l}"
            d, isz = ata.shape[-1], ata.element_size()
            print(f"[kernel] whole_factor    {dn} {note}: {whole_factor_variant(sched, d, isz)}-memory variant "
                  f"(factor, level table and 3 record buffers {whole_factor_smem_bytes(sched, d, isz)} bytes)")
            lv = level_inputs(prob, *plain_system(prob)[1:])
            fwd_ops = [fw for _, fw, _ in lv]
            got = _repeatable("level_fwd_subst", lambda: [level_fwd_subst(*f) for f in fwd_ops],
                              f"{dn} PGO {n}x{b} sweep")
            for li, (g, f) in enumerate(zip(got, fwd_ops)):
                e = _dev_report("level_fwd_subst", dn, g, level_fwd_subst_plain(*f),
                                f"{n}x{b} level {li:2d} C={f[0].shape[0]} ul={f[0].shape[1]}")
                max_abs["level_fwd_subst"][dn] = max(max_abs["level_fwd_subst"][dn], e)
            lflat = whole_factor(sched, ata)
            lflat_l = factorize_levels(sched, ata)
            with config.plain_path():
                lflat_p, f_ms = once_ms(lambda: whole_factor(sched, ata))
                y_p, y_ms = once_ms(lambda: whole_fwd_subst(sched, lflat_p, atb))
                x_p, x_ms = once_ms(lambda: whole_bwd_subst(sched, lflat_p, y_p))
            if dtype == torch.float32 and (n, b) == WHOLE_SHAPES[1]:
                for name, ms in (("whole_factor", f_ms), ("whole_fwd_subst", y_ms), ("whole_bwd_subst", x_ms)):
                    twin_ms[f"{name} {n}x{b}"] = ms
            y = whole_fwd_subst(sched, lflat_p, atb)
            x = whole_bwd_subst(sched, lflat_p, y_p)
            torch.cuda.synchronize()
            check(float(lflat[0].abs().max()) == 0.0, "whole_factor: slot 0 is not zero")
            for name, got, want, what in (("whole_factor", lflat, lflat_p, "twin"),
                                          ("whole_factor", lflat, lflat_l, "level kernels"),
                                          ("whole_fwd_subst", y, y_p, "twin"),
                                          ("whole_bwd_subst", x, x_p, "twin")):
                e = _dev_report(name, dn, got, want, f"{note} vs {what}")
                if what == "twin":
                    max_abs.setdefault(name, {})[dn] = max(max_abs.get(name, {}).get(dn, 0.0), e)
            # the level kernel forms each entry's update in whole_factor's
            # order and runs its POTRF / TRSM statements: the same bits
            diff = float((lflat_l - lflat).abs().max())
            print(f"[kernel] level_factor    {dn} {note}: factorize_levels vs whole_factor "
                  f"max |diff| = {diff!r} (must be exactly 0.0)")
            check(diff == 0.0, f"level_factor {dn} {note}: factor differs from whole_factor's by {diff!r}")
            # the whole forward sweep sums each output's list over the level's
            # gu lanes in the level kernel's order and tree: the level forward
            # sweep's bits, on the same factor
            plan = get_tables(sched).fwd_plan(d, isz)
            perm, _, _ = sched.on(atb.device)
            y_w = _repeatable("whole_fwd_subst", lambda: [whole_fwd_subst(sched, lflat_l, atb)],
                              f"{dn} PGO {n}x{b}")[0]
            y_l = forward_sweep(sched, lflat_l, atb[perm])
            torch.cuda.synchronize()
            diff = float((y_w - y_l).abs().max())
            print(f"[kernel] whole_fwd_subst {dn} {note}: {plan.n_stages} stages over {len(plan.gu)} levels, "
                  f"y in {'shared' if plan.vec_smem else 'device'} memory, "
                  f"{plan.smem} bytes; vs the level forward sweep max |diff| = {diff!r} (must be exactly 0.0)")
            check(bool(torch.isfinite(y_w).all()) and diff == 0.0,
                  f"whole_fwd_subst {dn} {note}: differs from the level forward sweep by {diff!r}")
            # the whole backward sweep runs each output's chain over the
            # column's rows in the level kernel's order, then its solve: the
            # level backward sweep's bits, on the same factor and y
            plan = get_tables(sched).bwd_plan(d, isz)
            _, iperm, _ = sched.on(atb.device)
            x_w = _repeatable("whole_bwd_subst", lambda: [whole_bwd_subst(sched, lflat_l, y_l)],
                              f"{dn} PGO {n}x{b}")[0]
            x_l = backward_sweep(sched, lflat_l, y_l)[iperm]
            torch.cuda.synchronize()
            diff = float((x_w - x_l).abs().max())
            print(f"[kernel] whole_bwd_subst {dn} {note}: {plan.n_stages} stages over {get_tables(sched).n_levels} "
                  f"levels, x in {'shared' if plan.vec_smem else 'device'} memory, {plan.smem} bytes; vs the "
                  f"level backward sweep max |diff| = {diff!r} (must be exactly 0.0)")
            check(bool(torch.isfinite(x_w).all()) and diff == 0.0,
                  f"whole_bwd_subst {dn} {note}: differs from the level backward sweep by {diff!r}")
        prob = synthetic_problem(*TRAIN, dtype, dev)
        v1, v2, meas = between_operands(prob)
        e = _dev_report("between_se3_aos", dn, between_linearize_fused(v1, v2, meas),
                        between_linearize_plain(v1, v2, meas), f"K={v1.shape[0]} B={v1.shape[1]}")
        max_abs.setdefault("between_se3_aos", {})[dn] = e
    torch.cuda.synchronize()
    return max_abs, twin_ms


# ---------------------------------------------------------------------------
# phase 4: the slices through TheseusLayer.forward
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


def phase_ba_slice(dev):
    import numpy as np
    import torch

    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.lie import se3

    # (a) the main path: 128 x 4000 x 1, float32, kernels; counters around it only
    prob = ba_problem(*BA_MAIN, torch.float32, dev)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out, info = prob.layer.forward(prob.inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    n_obs = reprojection_operands(prob)[0].shape[0]
    print(f"[ba-slice] {BA_MAIN[0]}x{BA_MAIN[1]}x{BA_MAIN[2]} ({n_obs} observations) float32 forward, "
          f"{ITERS} LM iterations: {wall:.3f} s wall, initial err {float(info.err_history[0].mean()):.8e}, "
          f"final {float(info.last_err.mean()):.8e}, launches {launches}")
    expect = {
        "reprojection": 2 * ITERS + 1,  # linearize + tentative error per iteration, + initial error
        "assemble_blocks": ITERS,
        "between_se3": 0, "level_factor": 0, "level_fwd_subst": 0, "level_bwd_subst": 0,
    }
    for k, v in expect.items():
        check(launches[k] == v, f"BA {k}: {launches[k]} launches, expected {v}")
    check(bool(torch.isfinite(info.last_err).all()), "BA: non-finite final error")
    check(bool((info.last_err < 1e-3 * info.err_history[0]).all()), "BA: the solve did not converge")
    for name, shape in (("cam", (BA_MAIN[0], BA_MAIN[2], 3, 4)), ("pt", (BA_MAIN[1], BA_MAIN[2], 3))):
        check(tuple(out[name].shape) == shape and bool(torch.isfinite(out[name]).all()),
              f"BA {name}: bad output {tuple(out[name].shape)}")

    # (b) the same problem, float64, plain twins on the card
    ref = ba_problem(*BA_MAIN, torch.float64, dev)
    _cuda.reset_launches()
    with config.plain_path():
        _, ref_info = ref.layer.forward(ref.inputs)
    check(sum(_cuda.launches.values()) == 0, "the plain path launched a kernel")
    rel = _rel(info.last_err, ref_info.last_err)
    print(f"[ba-slice] float32 kernels vs float64 plain twins on the card: max rel dev of per-batch "
          f"final error {float(rel.max()):.3e} (tol {BA_PLATEAU_RTOL_F32:.0e}); float64 mean final err "
          f"{float(ref_info.last_err.mean()):.8e}")
    check(float(rel.max()) <= BA_PLATEAU_RTOL_F32, "BA float32 plateau off the float64 plateau")

    # (c) the JAX float64 golden at 16 x 200 x 4
    golden, golden_iters = golden_errors(BA_GOLDEN)
    check(golden_iters == ITERS, "BA golden iteration count changed")
    golden_t = torch.as_tensor(golden)
    for dtype, tol in ((torch.float32, BA_PLATEAU_RTOL_F32), (torch.float64, PLATEAU_RTOL_F64)):
        g = ba_golden_problem(dtype, dev)
        _cuda.reset_launches()
        _, ginfo = g.layer.forward(g.inputs)
        check(_cuda.launches["reprojection"] == 2 * ITERS + 1, "BA golden solve missed the kernel")
        rel = _rel(ginfo.last_err, golden_t)
        dn = str(dtype).split(".")[-1]
        print(f"[ba-slice] 16x200x4 {dn} kernels vs JAX float64 golden: max rel dev {float(rel.max()):.3e} "
              f"(tol {tol:.0e}); mean {float(ginfo.last_err.mean()):.8e} vs {float(golden.mean()):.8e}")
        check(float(rel.max()) <= tol, f"BA 16x200x4 {dn} off the JAX golden")

    # (d) one more request: fresh initial cameras and points. The gauge
    # prior pins camera 0 to the same target, so the solve returns to the
    # same error plateau.
    gen = np.random.default_rng(1)
    cams, pts = prob.inputs["cam"], prob.inputs["pt"]
    tangent = torch.as_tensor(1e-3 * gen.standard_normal(tuple(cams.shape[:-2]) + (6,)),
                              dtype=torch.float32, device=dev)
    fresh = {"cam": se3.compose(cams, se3.exp(tangent)),
             "pt": pts + torch.as_tensor(1e-3 * gen.standard_normal(tuple(pts.shape)),
                                         dtype=torch.float32, device=dev)}
    _, rinfo = prob.layer.forward(fresh)
    rel = _rel(rinfo.last_err, ref_info.last_err)
    print(f"[ba-slice] request 2: fresh init, mean final err {float(rinfo.last_err.mean()):.8e}, "
          f"max rel dev from the float64 plateau {float(rel.max()):.3e}")
    check(bool(torch.isfinite(rinfo.last_err).all()), "BA fresh request: non-finite error")
    check(float(rel.max()) <= BA_PLATEAU_RTOL_F32, "BA fresh request: off the plateau")
    return launches


def phase_ba_intr(dev, card):
    """BAL's 9-parameter cameras at BAL_MAIN: `reprojection_intr` against
    its twin in float32 and float64 (and a ragged K B, each launched twice);
    a Schur LM solve through TheseusLayer.forward with its launch counts;
    the kernel's time back to back, on the device and of its twin, and its
    bound. Returns (launches, {"max_abs", "times", "dev_times", "bounds"})."""
    import torch

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.ops.reprojection import reprojection_intr_linearize, reprojection_intr_linearize_plain
    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, eliminate_landmarks

    name = "reprojection_intr"
    max_abs, out = {}, {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        ops = bal_operands(dtype, dev)
        check(tuple(ops[2].shape) == (BAL_MAIN[2], 1, 3), f"BAL intrinsics operand {tuple(ops[2].shape)}")
        note = f"K={ops[0].shape[0]} B={ops[0].shape[1]}"
        _cuda.reset_launches()
        got = _repeatable(name, lambda: reprojection_intr_linearize(*ops), f"{dn} BAL {note}")
        check(_cuda.launches[name] == 2, f"{name}: {_cuda.launches[name]} launches for two calls")
        worst = _dev_report(name, dn, got, reprojection_intr_linearize_plain(*ops), note)
        cut = [t[:-1] for t in ops]  # one item fewer: a K B that is a multiple of no block size
        cut_note = f"K={cut[0].shape[0]} B={cut[0].shape[1]} (ragged)"
        ragged = _repeatable(name, lambda: reprojection_intr_linearize(*cut), f"{dn} BAL {cut_note}")
        max_abs[dn] = max(worst, _dev_report(name, dn, ragged, reprojection_intr_linearize_plain(*cut), cut_note))
        if dtype == torch.float32:
            kernel_ms = cuda_ms(lambda: reprojection_intr_linearize(*ops))
            twin_ms = cuda_ms(lambda: reprojection_intr_linearize_plain(*ops), reps=3)
            out["dev_times"] = {name: device_ms(lambda: reprojection_intr_linearize(*ops))}
            out["times"] = {name: (kernel_ms, twin_ms)}
            n = ops[0].shape[0] * ops[0].shape[1]
            out["bounds"] = {name: _bound(_nbytes(*ops, *got), REPROJECTION_INTR_FLOPS * n)}
        del ops, got, cut, ragged
    out["max_abs"] = {name: max_abs}
    bms, by = out["bounds"][name]
    print(f"[timing] {name:<19} BAL {BAL_MAIN[2]}x1 float32, one call: kernel {out['times'][name][0]:.4f} ms back "
          f"to back, {out['dev_times'][name]:.4f} ms device (queue prefilled), plain twin "
          f"{out['times'][name][1]:.4f} ms (CUDA events); bound {bms:.4f} ms ({by}) on {card}")

    # the main path: the Schur LM solve, each camera one 9-dof block of S;
    # counters reset just before the solve
    prob, obj, pts = bal_parts(torch.float32, dev)
    inputs = ba_values(prob, optimize_intrinsics=True)
    solve = Problem(obj, inputs, eliminate=eliminate_landmarks(pts), **BA_OPTS)
    check((solve.builder.n_cams, solve.builder.cam_d) == (BAL_MAIN[0], 9),
          f"BAL: S has {solve.builder.n_cams} blocks of {solve.builder.cam_d}, expected {BAL_MAIN[0]} of 9")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res, info = solve.layer.forward(inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    useful, padded = solve.builder.pair_counts()
    first, last = float(info.err_history[0].mean()), float(info.last_err.mean())

    # over all cameras, each intrinsic's step and its distance to the truth,
    # over its initial distance to the truth; printed, the step held (intrinsics
    # that never move read 0). The truth is no target: f trades against each
    # camera's depth, and k2 moves a feature by ~f r^4 |p|, ~1 pixel a unit
    init, gt = inputs["intr"], prob.gt_intrinsics
    scale = [torch.linalg.norm(init[..., j] - gt[..., j]) for j in range(3)]
    to_truth = [float(torch.linalg.norm(res["intr"][..., j] - gt[..., j]) / scale[j]) for j in range(3)]
    step = [float(torch.linalg.norm(res["intr"][..., j] - init[..., j]) / scale[j]) for j in range(3)]
    print(f"[ba-intr] BAL {BAL_MAIN[0]}x{BAL_MAIN[1]}x1 ({BAL_MAIN[2]} observations) float32 Schur forward, "
          f"{ITERS} LM iterations: {wall:.3f} s wall, initial err {first:.8e}, final {last:.8e}; f, k1, k2: "
          f"distance to the truth {to_truth} and step {step} of the initial distance; pairs useful {useful}, "
          f"padded {padded}; launches { {k: v for k, v in launches.items() if v} } on {card}")
    expect = {
        name: 2 * ITERS + 1,  # linearize + tentative error per iteration, + initial error
        "assemble_blocks": ITERS,
        "reprojection": 0, "between_se3": 0, "level_factor": 0, "level_fwd_subst": 0, "level_bwd_subst": 0,
    }
    for k, v in expect.items():
        check(launches[k] == v, f"BAL {k}: {launches[k]} launches, expected {v}")
    check(bool(torch.isfinite(info.last_err).all()) and last < 0.1 * first, "BAL: the solve did not converge")
    check(min(step) > 0.01, "BAL: the solve left the intrinsics where they started")
    check(useful == int((torch.bincount(torch.as_tensor(prob.obs_pt), minlength=BAL_MAIN[1]) ** 2).sum()),
          "BAL: pair_counts' useful pairs are not the tracks' sum of k^2")
    return launches, out


def train_problem(n, b, dtype, dev, iters=ITERS):
    """The flagship training problem: (layer, pose inputs, ground truth)."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.pose_graph import (
        build_pgo_objective, pose_values, synthetic_pose_graph, training_weights)

    gt, edges, meas, init = synthetic_pose_graph(n, b, seed=0, dtype=dtype, device=dev)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=dtype, device=dev,
                                 edge_weight=w_odo, loop_weight=w_loop)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True,
                                                  linearization="sparse"))
    return layer, pose_values(init), gt


def train_step(layer, poses, gt, theta, mode="implicit"):
    """One forward and backward() of the outer loss; returns (loss, info,
    launches during forward, launches during backward)."""
    import torch

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

    theta.grad = None
    before = dict(_cuda.launches)
    out, info = layer.forward(dict(poses, w_loop=theta.reshape(1, 1)), optimizer_kwargs={"backward_mode": mode})
    loss = mean_sq_local(out, gt)
    mid = dict(_cuda.launches)
    loss.backward()
    torch.cuda.synchronize()
    after = dict(_cuda.launches)
    return (loss.detach(), info, {k: mid[k] - before[k] for k in mid},
            {k: after[k] - mid[k] for k in mid})


def _grad_at(dtype, dev, whole, plain=False, shape=None, mode="implicit", iters=ITERS):
    """d loss / d theta at THETA0 of one training step."""
    import torch

    from theseus_tpu_torch import config

    layer, poses, gt = train_problem(*(shape or TRAIN), dtype, dev, iters=iters)
    theta = torch.tensor(THETA0, dtype=dtype, device=dev, requires_grad=True)
    config.set_whole_sweep(whole)
    try:
        if plain:
            with config.plain_path():
                loss, _, fwd, bwd = train_step(layer, poses, gt, theta, mode)
        else:
            loss, _, fwd, bwd = train_step(layer, poses, gt, theta, mode)
    finally:
        config.set_whole_sweep(False)
    return float(loss), float(theta.grad), fwd, bwd


LEVEL_KERNELS = ("level_factor", "level_fwd_subst", "level_bwd_subst")


def phase_train(dev):
    """The training path: SGD_STEPS implicit steps at 256 x 128 float32 on
    the whole-sweep kernels, counters reset just before and read just
    after, checked around each forward and backward()."""
    import numpy as np
    import torch

    from theseus_tpu_torch import _cuda, config

    layer, poses, gt = train_problem(*TRAIN, torch.float32, dev)
    theta = torch.tensor(THETA0, dtype=torch.float32, device=dev, requires_grad=True)
    losses, grads, sgd = [], [], None
    config.set_whole_sweep(True)
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        for step in range(SGD_STEPS):
            loss, info, fwd, bwd = train_step(layer, poses, gt, theta)
            g = theta.grad.detach().clone()
            if sgd is None:
                sgd = torch.optim.SGD([theta], lr=SGD_FIRST_STEP / max(abs(float(g)), 1e-30))
            sgd.step()
            losses.append(float(loss))
            grads.append(float(g))
            # one solve per LM iteration the early-exit loop ran (history rows
            # past the initial one) and one for the final Gauss-Newton step
            solves = int(torch.isfinite(info.err_history).all(dim=1).sum())
            print(f"[train] step {step}: loss {losses[-1]:.8e}, d loss/d theta {grads[-1]:.6e}, "
                  f"theta -> {float(theta.detach()):.6f}; {solves} solves; forward launches "
                  f"{ {k: v for k, v in fwd.items() if v} }, backward launches { {k: v for k, v in bwd.items() if v} }")
            check(np.isfinite(losses[-1]) and np.isfinite(grads[-1]) and grads[-1] != 0.0,
                  "training step: loss or gradient not finite, or zero gradient")
            for k in ("whole_factor", "whole_fwd_subst", "whole_bwd_subst"):
                check(fwd[k] == solves, f"forward: {k} launched {fwd[k]} times for {solves} solves")
            check(bwd["whole_factor"] == 0, "backward() launched a factorization")
            check(bwd["whole_fwd_subst"] == 1 and bwd["whole_bwd_subst"] == 1,
                  f"backward(): substitution launches {bwd['whole_fwd_subst']}, {bwd['whole_bwd_subst']}, expected 1, 1")
            check(all(fwd[k] == 0 and bwd[k] == 0 for k in LEVEL_KERNELS), "the whole-sweep step ran level kernels")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        config.set_whole_sweep(False)
    launches = dict(_cuda.launches)
    print(f"[train] {TRAIN[0]}x{TRAIN[1]} float32, {SGD_STEPS} implicit steps in {wall:.3f} s wall, "
          f"launches {launches}")
    check(losses[-1] < losses[0], f"the outer loss did not fall: {losses}")

    # the same first step: float64 plain twins (level plan) and float32 level kernels
    _, g64, _, _ = _grad_at(torch.float64, dev, whole=False, plain=True)
    rel = abs(grads[0] - g64) / abs(g64)
    print(f"[train] gradient, float32 whole-sweep kernels vs float64 plain twins: {grads[0]:.6e} vs {g64:.6e}, "
          f"rel {rel:.3e} (tol {GRAD_RTOL_F32:.0e}: float32 LM plateau)")
    check(rel <= GRAD_RTOL_F32, "training gradient off the float64 twin gradient")
    _, gl, fwd, bwd = _grad_at(torch.float32, dev, whole=False)
    check(all(fwd[k] > 0 for k in LEVEL_KERNELS) and fwd["whole_factor"] == 0 and bwd["level_factor"] == 0,
          "the level-plan step did not run the level kernels alone")
    rel = abs(grads[0] - gl) / abs(gl)
    print(f"[train] gradient, whole-sweep vs level kernels (float32): {grads[0]:.6e} vs {gl:.6e}, "
          f"rel {rel:.3e} (tol {GRAD_RTOL_F32:.0e})")
    check(rel <= GRAD_RTOL_F32, "whole-sweep gradient off the level-plan gradient")

    # unroll at smaller depth, float64: the d_ata path of the solve's backward
    n, b, iters = UNROLL
    _, gu, fwd, bwd = _grad_at(torch.float64, dev, whole=True, shape=(n, b), mode="unroll", iters=iters)
    _, gup, _, _ = _grad_at(torch.float64, dev, whole=False, plain=True, shape=(n, b), mode="unroll", iters=iters)
    rel = abs(gu - gup) / abs(gup)
    print(f"[train] unroll {n}x{b} float64, {iters} LM iterations: kernels {gu:.12e} vs plain twins {gup:.12e}, "
          f"rel {rel:.3e} (tol {GRAD_RTOL_F64:.0e}); backward launches "
          f"{ {k: v for k, v in bwd.items() if v} }")
    check(rel <= GRAD_RTOL_F64 and gu != 0.0, "unrolled gradient off the twins")
    check(bwd["whole_factor"] == 0 and bwd["whole_fwd_subst"] == iters, "unroll backward launches")
    return launches


def phase_aos_entry(dev):
    """Row 9's entry point, as its caller would use it: one call at the PGO
    main path's Between shape, counters reset just before."""
    import torch

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.ops.between_se3 import between_linearize_fused

    v1, v2, meas = between_operands(synthetic_problem(*TRAIN, torch.float32, dev))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    j1, j2, err = between_linearize_fused(v1, v2, meas)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    check(launches["between_se3_aos"] == 1 and bool(torch.isfinite(err).all()), "AoS Between entry")
    return launches


# ---------------------------------------------------------------------------
# the dense tail: a grid PGO, denser than a chain
# ---------------------------------------------------------------------------
def grid_problem(rows, cols, batch, dtype, dev, training=False, seed=0):
    """A rows x cols grid of poses (a robot's back-and-forth sweep), numbered
    along the chain that snakes through it: the chain's edges (odometry),
    then every vertical edge the chain does not take (loop closures), and a
    Local prior on pose 0. Ground truth, measurements (noise 0.05) and
    initialization (noise 0.2) from a numpy seed. training: the odometry
    and loop-closure weights of `training_weights`. Returns (objective, pose
    inputs, ground truth (N, B, 3, 4))."""
    import numpy as np
    import torch

    from theseus_tpu_torch.lie import se3
    from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, training_weights

    at = lambda i, j: i * cols + (j if i % 2 == 0 else cols - 1 - j)  # noqa: E731
    n = rows * cols
    vertical = [(min(at(i, j), at(i + 1, j)), max(at(i, j), at(i + 1, j)))
                for i in range(rows - 1) for j in range(cols)]
    edges = [(k, k + 1) for k in range(n - 1)] + [e for e in vertical if e[1] - e[0] > 1]
    rng = np.random.default_rng(seed)
    normal = lambda *shape: torch.as_tensor(rng.standard_normal(shape))  # noqa: E731
    gt = se3.exp(0.5 * normal(n, batch, 6))
    e = torch.as_tensor(edges)
    meas = se3.compose(se3.compose(se3.inverse(gt[e[:, 0]]), gt[e[:, 1]]), se3.exp(0.05 * normal(len(edges), batch, 6)))
    init = se3.compose(gt, se3.exp(0.2 * normal(n, batch, 6)))
    kw = dict(zip(("edge_weight", "loop_weight"), training_weights())) if training else {}
    obj, _ = build_pgo_objective(n, edges, meas, gt[0], dtype=dtype, device=dev, **kw)
    cast = lambda t: t.to(dtype=dtype, device=dev)  # noqa: E731
    return obj, pose_values(cast(init)), cast(gt)


def phase_tail(dev):
    """The grid PGO at GRID (16 x 16 poses at batch 128: a 51-column dense
    tail after 14 head levels) through TheseusLayer.forward, float32, the
    counters reset just before and read just after: the head through the
    level kernels, the tail through one cholesky_ex a factorization. The
    final error against the float64 plain-twin solve on the card, then one
    implicit training step against the float64 twins' gradient."""
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

    rows, cols, batch = GRID
    prob = grid_prob(torch.float32, dev)
    layer, inputs, sched = prob.layer, prob.inputs, prob.builder.sched
    n_levels = len(sched.level_tables)
    check(sched.tail_k > 0 and sched.n_head > 0, "the grid has no dense tail")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    # count the tail's dense POTRFs: every call goes to cholesky_ex itself
    with mock.patch("torch.linalg.cholesky_ex", wraps=torch.linalg.cholesky_ex) as potrf:
        t0 = time.perf_counter()
        out, info = layer.forward(inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    print(f"[tail] grid {rows}x{cols} ({rows * cols} poses, head {sched.n_head} columns in {n_levels} levels, "
          f"tail {sched.tail_k} columns: ({batch}, {sched.tail_k * 6}, {sched.tail_k * 6}) a POTRF) x batch "
          f"{batch} float32 forward, {ITERS} LM iterations: {wall:.3f} s wall, mean final err "
          f"{float(info.last_err.mean()):.8e}, launches {launches}, cholesky_ex {potrf.call_count}")
    expect = {"between_se3": 2 * ITERS + 1, "assemble_blocks": ITERS, "level_factor": ITERS * n_levels,
              "level_fwd_subst": ITERS * n_levels, "level_bwd_subst": ITERS * n_levels, "whole_factor": 0,
              "tail_update": ITERS}
    for k, v in expect.items():
        check(launches[k] == v, f"tail: {k} {launches[k]} launches, expected {v}")
    check(potrf.call_count == ITERS, f"tail: {potrf.call_count} cholesky_ex calls for {ITERS} factorizations")
    check(bool(torch.isfinite(info.last_err).all()), "tail: non-finite final error")
    check(all(tuple(t.shape) == (batch, 3, 4) and bool(torch.isfinite(t).all())
              for k, t in out.items() if k.startswith("pose_")), "tail: bad output poses")
    # the LM iteration never waits for the card: one iteration enqueued
    # behind a one-second sleep kernel returns to the host long before it
    opt, opts = prob.opt, prob.opt.opts
    with torch.no_grad():
        carry = opt.run_scan(opt.init_carry(prob.state, prob.aux, opts), prob.aux, 1, opts)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S))
        t0 = time.perf_counter()
        carry = opt.run_scan(carry, prob.aux, 1, opts)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print(f"[tail] one LM iteration enqueued behind a 1 s sleep kernel: the host returned after {host_ms:.2f} ms "
          f"(a host sync would wait for the sleep)")
    check(host_ms < 500.0, "tail: the LM iteration waited for the card")

    ref = grid_prob(torch.float64, dev)
    _cuda.reset_launches()
    with config.plain_path():
        _, ref_info = ref.layer.forward(ref.inputs)
    check(sum(_cuda.launches.values()) == 0, "the plain path launched a kernel")
    rel = _rel(info.last_err, ref_info.last_err)
    print(f"[tail] float32 kernels vs float64 plain twins on the card: max rel dev of per-batch final error "
          f"{float(rel.max()):.3e} (tol {PLATEAU_RTOL_F32:.0e}); float64 mean final err "
          f"{float(ref_info.last_err.mean()):.8e}")
    check(float(rel.max()) <= PLATEAU_RTOL_F32, "tail: float32 plateau off the float64 plateau")

    def grad(dtype, plain):
        g_obj, g_inputs, gt = grid_problem(rows, cols, batch, dtype, dev, training=True)
        g_layer = tt.TheseusLayer(tt.LevenbergMarquardt(g_obj, max_iterations=ITERS, adaptive_damping=True,
                                                        linearization="sparse"))
        theta = torch.tensor(THETA0, dtype=dtype, device=dev, requires_grad=True)
        with config.plain_path() if plain else contextlib.nullcontext():
            before = dict(_cuda.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, _ = g_layer.forward(dict(g_inputs, w_loop=theta.reshape(1, 1)),
                                   optimizer_kwargs={"backward_mode": "implicit"})
            loss = mean_sq_local(o, gt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        used = {k: v - before[k] for k, v in _cuda.launches.items() if v != before[k]}
        return float(loss.detach()), float(theta.grad), used, ((t1 - t0) * 1e3, (t2 - t1) * 1e3)

    loss, g32, used, first_ms = grad(torch.float32, False)
    _, g64, _, _ = grad(torch.float64, True)
    rel = abs(g32 - g64) / abs(g64)
    print(f"[tail] implicit training step: loss {loss:.8e}, d loss/d theta float32 kernels {g32:.6e} vs float64 "
          f"plain twins {g64:.6e}, rel {rel:.3e} (tol {GRAD_RTOL_F32:.0e}); launches {used}")
    again_ms = grad(torch.float32, False)[3]
    print(f"[tail] implicit training step {rows}x{cols}x{batch} float32 kernels, (forward, backward()) ms, each "
          f"ended by a sync: first ({first_ms[0]:.3f}, {first_ms[1]:.3f}), again on a fresh layer "
          f"({again_ms[0]:.3f}, {again_ms[1]:.3f})")
    check(all(used.get(k, 0) > 0 for k in LEVEL_KERNELS), "tail training step missed the level kernels")
    check(g32 != 0.0 and rel <= GRAD_RTOL_F32, "tail: training gradient off the float64 twin gradient")
    return launches


# ---------------------------------------------------------------------------
# the robust BA training step, the DLM steps and the g2o reader
# ---------------------------------------------------------------------------
def ba_train_layer(shape, dtype, dev, log_radius, iters=ITERS):
    """The robust BA training problem at shape (cameras, points, batch):
    (layer, inputs, ground-truth cameras)."""
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective, synthetic_ba

    cams, pts, batch = shape
    prob = synthetic_ba(cams, pts, batch=batch, seed=0, visibility=BA_VISIBILITY, outlier_fraction=BA_OUTLIERS,
                        dtype=dtype, device=dev)
    obj, _, pt_fam = build_ba_objective(prob, dtype=dtype, device=dev, robust_loss_cls=tt.HuberLoss,
                                        log_loss_radius=log_radius, gauge_target=prob.gt_poses[0])
    obj.add(tt.Local(pt_fam[0], prob.gt_points[0].cpu().numpy(), tt.ScaleCostWeight(BA_SCALE_PIN),
                     name="scale_pin"))
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=iters, **BA_OPTS))
    return layer, ba_values(prob), prob.gt_poses


def ba_outer_loss(out, gt):
    """Mean squared SE3 local from each solved camera to its ground truth."""
    import torch

    from theseus_tpu_torch.lie import se3

    d = se3.log(se3.compose(se3.inverse(out["cam"]), gt))
    return torch.mean(torch.sum(d * d, dim=-1))


def timed_step(forward, loss_fn, leaf):
    """One training step: (loss, d loss / d leaf, forward ms, backward() ms,
    launches in forward, launches in backward()), each part ended by a
    sync."""
    import torch

    from theseus_tpu_torch import _cuda

    leaf.grad = None
    torch.cuda.synchronize()
    before = dict(_cuda.launches)
    t0 = time.perf_counter()
    out = forward()
    loss = loss_fn(out)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mid = dict(_cuda.launches)
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after = dict(_cuda.launches)
    return (float(loss.detach()), leaf.grad.detach().clone(), (t1 - t0) * 1e3, (t2 - t1) * 1e3,
            {k: mid[k] - before[k] for k in mid}, {k: after[k] - mid[k] for k in mid})


def ba_train_grad(shape, dtype, dev, mode="implicit", plain=False, iters=ITERS):
    """(loss, d loss / d log radius, forward ms, backward ms) of one step."""
    import torch

    from theseus_tpu_torch import config

    log_radius = torch.full((1, 1), BA_LOG_RADIUS0, dtype=dtype, device=dev, requires_grad=True)
    layer, inputs, gt = ba_train_layer(shape, dtype, dev, log_radius, iters)
    with config.plain_path() if plain else contextlib.nullcontext():
        loss, g, f_ms, b_ms, _, _ = timed_step(
            lambda: layer.forward(inputs, optimizer_kwargs={"backward_mode": mode})[0],
            lambda out: ba_outer_loss(out, gt), log_radius)
    return loss, float(g), f_ms, b_ms


def phase_ba_train(dev):
    """The robust BA training path: BA_SGD_STEPS implicit steps at BA_MAIN
    float32 on the kernels, the log radius of the Huber loss learned by SGD,
    counters reset just before and read just after; then the gradient
    against the float64 plain twins and float64 kernels, and an unrolled
    float64 step at BA_SMALL."""
    import numpy as np
    import torch

    from theseus_tpu_torch import _cuda

    log_radius = torch.full((1, 1), BA_LOG_RADIUS0, dtype=torch.float32, device=dev, requires_grad=True)
    layer, inputs, gt = ba_train_layer(BA_MAIN, torch.float32, dev, log_radius)
    label = "{}x{}x{}".format(*BA_MAIN)
    grads, sgd, step_ms = [], None, []
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for step in range(BA_SGD_STEPS):
        loss, g, f_ms, b_ms, fwd, bwd = timed_step(
            lambda: layer.forward(inputs, optimizer_kwargs={"backward_mode": "implicit"})[0],
            lambda out: ba_outer_loss(out, gt), log_radius)
        if sgd is None:
            sgd = torch.optim.SGD([log_radius], lr=SGD_FIRST_STEP / max(abs(float(g)), 1e-30))
        sgd.step()
        grads.append(float(g))
        step_ms.append((f_ms, b_ms))
        print(f"[ba-train] step {step}: loss {loss:.8e}, d loss/d log_radius {grads[-1]:.6e}, log_radius -> "
              f"{float(log_radius.detach()):.6f}; forward {f_ms:.3f} ms, backward() {b_ms:.3f} ms; forward "
              f"launches { {k: v for k, v in fwd.items() if v} }, backward launches "
              f"{ {k: v for k, v in bwd.items() if v} }")
        check(np.isfinite(loss) and np.isfinite(grads[-1]) and grads[-1] != 0.0,
              "BA training step: loss or gradient not finite, or zero gradient")
        check(fwd["reprojection"] > 0 and fwd["assemble_blocks"] > 0,
              "BA training forward did not launch the Reprojection and assembly kernels")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    print(f"[ba-train] {label} float32 Huber, {BA_SGD_STEPS} implicit steps in {wall:.3f} s wall, "
          f"launches {launches}")

    _, g64, f64_ms, b64_ms = ba_train_grad(BA_MAIN, torch.float64, dev, plain=True)
    rel = abs(grads[0] - g64) / abs(g64)
    print(f"[ba-train] gradient, float32 kernels vs float64 plain twins: {grads[0]:.6e} vs {g64:.6e}, rel "
          f"{rel:.3e} (tol {GRAD_RTOL_F32:.0e}: the float32 plateau); twins forward {f64_ms:.3f} ms, "
          f"backward() {b64_ms:.3f} ms")
    check(rel <= GRAD_RTOL_F32, "BA training gradient off the float64 twin gradient")
    _, g32p, _, _ = ba_train_grad(BA_MAIN, torch.float32, dev, plain=True)
    print(f"[ba-train] gradient, float32 plain twins on the card: {g32p:.6e}, rel to float64 "
          f"{abs(g32p - g64) / abs(g64):.3e}, to the float32 kernels {abs(g32p - grads[0]) / abs(grads[0]):.3e}")
    _, gk64, _, _ = ba_train_grad(BA_MAIN, torch.float64, dev)
    rel = abs(gk64 - g64) / abs(g64)
    print(f"[ba-train] gradient, float64 kernels vs float64 plain twins: {gk64:.12e} vs {g64:.12e}, rel "
          f"{rel:.3e} (tol {GRAD_RTOL_F64:.0e})")
    check(rel <= GRAD_RTOL_F64, "BA float64 kernel gradient off the twins")

    # unroll at BA_SMALL, float64: the Reprojection Function's backward and
    # the Schur solve's d_ata path
    _, gu, _, _ = ba_train_grad(BA_SMALL, torch.float64, dev, mode="unroll", iters=BA_UNROLL_ITERS)
    _, gup, _, _ = ba_train_grad(BA_SMALL, torch.float64, dev, mode="unroll", plain=True, iters=BA_UNROLL_ITERS)
    rel = abs(gu - gup) / abs(gup)
    print(f"[ba-train] unroll {'x'.join(map(str, BA_SMALL))} float64, {BA_UNROLL_ITERS} LM iterations: kernels "
          f"{gu:.12e} vs plain twins {gup:.12e}, rel {rel:.3e} (tol {GRAD_RTOL_F64:.0e})")
    check(gu != 0.0 and rel <= GRAD_RTOL_F64, "BA unrolled gradient off the twins")
    return launches, step_ms


def phase_dlm(dev):
    """DLM training steps: PGO TRAIN float32 on the level plan and on the
    whole-sweep plan (counters reset just before each step and read around
    forward and backward()), gradients against the float64 plain twins; a
    float64 DLM step on BA_SMALL, kernels against twins."""
    import numpy as np
    import torch

    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

    _, g64, _, _ = _grad_at(torch.float64, dev, whole=False, plain=True, mode="dlm")
    launches, step_ms = {}, {}
    _cuda.reset_launches()
    for whole in (False, True):
        plan = "whole" if whole else "level"
        layer, poses, gt = train_problem(*TRAIN, torch.float32, dev)
        n_levels = len(layer.optimizer.normal_builder.sched.level_tables)
        theta = torch.tensor(THETA0, dtype=torch.float32, device=dev, requires_grad=True)
        config.set_whole_sweep(whole)
        try:
            loss, g, f_ms, b_ms, fwd, bwd = timed_step(
                lambda: layer.forward(dict(poses, w_loop=theta.reshape(1, 1)),
                                      optimizer_kwargs={"backward_mode": "dlm"})[0],
                lambda out: mean_sq_local(out, gt), theta)
        finally:
            config.set_whole_sweep(False)
        g = float(g)
        step_ms[plan] = (f_ms, b_ms)
        rel = abs(g - g64) / abs(g64)
        print(f"[dlm] {TRAIN[0]}x{TRAIN[1]} float32 {plan} plan: loss {loss:.8e}, d loss/d theta {g:.6e} vs float64 "
              f"plain twins {g64:.6e}, rel {rel:.3e} (tol {GRAD_RTOL_F32:.0e}); forward {f_ms:.3f} ms, backward() "
              f"{b_ms:.3f} ms; backward launches { {k: v for k, v in bwd.items() if v} }")
        check(np.isfinite(g) and g != 0.0 and rel <= GRAD_RTOL_F32, f"DLM {plan}: gradient off the float64 twins")
        # backward(): one normal system at the solution (one linearization
        # and assembly) and two perturbed solves, each a factorization and
        # both substitution sweeps
        if whole:
            want = {"whole_factor": 2, "whole_fwd_subst": 2, "whole_bwd_subst": 2, "level_factor": 0}
        else:
            want = {k: 2 * n_levels for k in LEVEL_KERNELS}
            want["whole_factor"] = 0
        want["assemble_blocks"] = 1
        for k, v in want.items():
            check(bwd[k] == v, f"DLM {plan} backward(): {k} launched {bwd[k]} times, expected {v}")
        check(bwd["between_se3"] > 0, "DLM backward() did not launch the Between kernel")
        for k, v in fwd.items():
            launches[k] = launches.get(k, 0) + v + bwd[k]

    # BA, float64 (see DLM_BA_ITERS): kernels against twins
    _, gd, _, _ = ba_train_grad(BA_SMALL, torch.float64, dev, mode="dlm", iters=DLM_BA_ITERS)
    _, gdp, _, _ = ba_train_grad(BA_SMALL, torch.float64, torch.device("cpu"), mode="dlm", plain=True,
                                 iters=DLM_BA_ITERS)
    rel = abs(gd - gdp) / abs(gdp)
    print(f"[dlm] BA {'x'.join(map(str, BA_SMALL))} float64 Huber, {DLM_BA_ITERS} LM iterations: d loss/d log_radius "
          f"kernels {gd:.12e} vs plain twins on the CPU {gdp:.12e}, rel {rel:.3e} (tol {GRAD_RTOL_F64:.0e})")
    check(gd != 0.0 and rel <= GRAD_RTOL_F64, "BA DLM gradient off the twins")
    return launches, step_ms


def phase_g2o(dev):
    """`read_3d_g2o` of tests/fixtures/mini_3d.g2o onto the card (its
    default device) and the LM solve back to zero error in float64, the JAX
    package's test plateau."""
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, read_3d_g2o

    n, poses, edges, meas, w = read_3d_g2o(G2O)
    check(poses.device.type == "cuda" and tuple(poses.shape) == (n, 1, 3, 4) and tuple(w.shape) == (len(edges), 6, 6),
          "read_3d_g2o: not on the card or bad shapes")
    obj, _ = build_pgo_objective(n, edges, meas, poses[0], dtype=torch.float64)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=15, adaptive_damping=True,
                                                  linearization="sparse"))
    _cuda.reset_launches()
    _, info = layer.forward(pose_values(poses))
    first, last = float(info.err_history[0].mean()), float(info.last_err.mean())
    print(f"[g2o] {G2O.relative_to(ROOT)}: {n} poses, {len(edges)} edges on {poses.device}; float64 LM error "
          f"{first:.6e} -> {last:.3e} (tol 1e-10); launches { {k: v for k, v in _cuda.launches.items() if v} }")
    check(first > 1e-3 and last < 1e-10, "g2o: the loaded graph did not solve to zero error")
    check(_cuda.launches["between_se3"] > 0, "g2o: the solve ran no kernel")


def ik_residual_norm(fk, theta, targets):
    """Per batch element: the norm of the SE3 local of the end effector's
    pose at theta to its target, in float64."""
    import torch

    from theseus_tpu_torch.lie import SE3

    (pose,) = fk(theta.double())
    return torch.linalg.vector_norm(SE3.local(targets.double(), pose), dim=-1)


def phase_ik(dev, card):
    """The IK serving path: the 7-dof arm (utils/examples/inverse_kinematics.py),
    an AutoDiffCostFunction over FK (jacrev), LM with adaptive damping on the
    default dense linearization, IK_ITERS iterations from zero, float32, through
    TheseusLayer.forward at each of IK_BATCHES with fresh targets per call,
    each call ended by a sync; float32 against float64 at IK_CHECK_BATCH;
    the float64 card solve against the CPU; one LM iteration behind a sleep
    kernel (no host sync); synced stage times and a profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.utils.examples.inverse_kinematics import (
        IK_ITERS, build_ik_layer, ik_targets, perturb_targets)

    t_phase = time.perf_counter()
    rows = []
    layer, fk, robot = build_ik_layer(torch.float32, dev)
    check(layer.optimizer.linearization == "dense", "IK: the default linearization is not dense")
    for batch in IK_BATCHES:
        targets = ik_targets(fk, robot.dof, batch, torch.float32, dev)
        theta0 = torch.zeros(batch, robot.dof, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out, info = layer.forward({"theta": theta0, "target": targets})
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        check(sum(_cuda.launches.values()) == 0, "IK: a kernel of the table launched on the IK path")
        check(tuple(out["theta"].shape) == (batch, robot.dof) and bool(torch.isfinite(out["theta"]).all())
              and bool(torch.isfinite(info.last_err).all()), f"IK batch {batch}: bad output")
        times, errs = [], []
        for i in range(IK_REQUESTS):
            request = perturb_targets(targets, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, info = layer.forward({"theta": theta0, "target": request})
            err = info.last_err.mean()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            errs.append(float(err))
        ms = sum(times) / len(times)
        rows.append({"batch": batch, "ms_per_call": ms, "min_ms": min(times), "solves_per_s": batch / ms * 1e3,
                     "mean_final_err": sum(errs) / len(errs), "first_call_ms": first_ms})
        print(f"[ik] 7-dof IK float32, batch {batch}: {ms:.3f} ms/call (mean of {IK_REQUESTS} requests, min "
              f"{min(times):.3f}; first call {first_ms:.3f}), {batch / ms * 1e3:.1f} solves/s, mean final err "
              f"{rows[-1]['mean_final_err']:.6e}, on {card}")

    print(f"[ik] serving done at {time.perf_counter() - t_phase:.1f} s of the phase")
    # float32 against float64 on the same targets (joint angles drawn in
    # float64), per batch element
    b = IK_CHECK_BATCH
    l64, fk64, _ = build_ik_layer(torch.float64, dev)
    tg = ik_targets(fk64, robot.dof, b, torch.float64, dev)
    out32, info32 = layer.forward({"theta": torch.zeros(b, robot.dof, dtype=torch.float32, device=dev),
                                   "target": tg.float()})
    out64, info64 = l64.forward({"theta": torch.zeros(b, robot.dof, dtype=torch.float64, device=dev),
                                 "target": tg})
    joint = (out32["theta"].double() - out64["theta"]).abs().amax(-1)
    r32, r64 = ik_residual_norm(fk64, out32["theta"], tg), ik_residual_norm(fk64, out64["theta"], tg)
    n_joint, n_task = int((joint > IK_BASIN).sum()), int(((r32 - r64).abs() > IK_BASIN).sum())
    solved = r64 < IK_SOLVED
    n_solved, n_miss = int(solved.sum()), int((solved & (r32 > IK_TASK_TOL)).sum())
    worst = float(r32[solved].max())
    print(f"[ik] batch {b} float32 vs float64 on the card, per element: joint angles more than {IK_BASIN:.0e} apart "
          f"in {n_joint} of {b} ({100 * n_joint / b:.1f} %), the rest within "
          f"{float(joint[joint <= IK_BASIN].max()):.3e} rad (the arm is redundant: float32 ends at another point "
          f"of the solution set); pose residual norms more than {IK_BASIN:.0e} apart in {n_task} of {b}. float64 "
          f"brings {n_solved} of {b} to the target (residual < {IK_SOLVED:.0e}); float32 misses {n_miss} of them "
          f"(residual > {IK_TASK_TOL:.0e}; tol under {IK_MISS_SHARE:.0%}), its worst residual there {worst:.3e}")
    check(n_solved > 0 and n_miss < IK_MISS_SHARE * n_solved, "IK: float32 misses targets that float64 reaches")

    print(f"[ik] float32 vs float64 done at {time.perf_counter() - t_phase:.1f} s of the phase")
    # the float64 card solve against the same solve on the CPU
    lcpu, _, _ = build_ik_layer(torch.float64, "cpu")
    small = tg[:IK_CPU_BATCH]
    outc, _ = lcpu.forward({"theta": torch.zeros(IK_CPU_BATCH, robot.dof, dtype=torch.float64),
                            "target": small.cpu()})
    dev_cpu = float((out64["theta"][:IK_CPU_BATCH].cpu() - outc["theta"]).abs().max())
    print(f"[ik] float64 on the card vs the CPU, batch {IK_CPU_BATCH}: max joint angle difference {dev_cpu:.3e} "
          f"(tol {IK_F64_TOL:.0e})")
    check(dev_cpu <= IK_F64_TOL, "IK: float64 on the card off the CPU solve")

    print(f"[ik] card vs CPU done at {time.perf_counter() - t_phase:.1f} s of the phase")
    # where an iteration's time goes, at the check batch, float32
    opt, co = layer.optimizer, layer.objective.compile()
    values = layer.objective.default_values({"theta": torch.zeros(b, robot.dof, device=dev), "target": tg.float()})
    state, aux = co.pack(values, b), co.build_aux(values, b)
    bld = opt.normal_builder
    with torch.no_grad():
        ns = bld.build(state, aux)
        delta, _ = ns.solve(1e-3, False)
        fwd_layer, _, _ = build_ik_layer(torch.float32, dev, autograd_mode="fwd")
        fco = fwd_layer.objective.compile()
        stages = {
            "linearize (vmap, jacrev over FK)": lambda: co.linearize_blocks(state, aux),
            "linearize (vmap, jacfwd over FK)": lambda: fco.linearize_blocks(state, aux),
            "dense A, AtA, Atb": lambda: bld.build(state, aux),
            "solve (cholesky_ex)": lambda: ns.solve(1e-3, False),
            "retract": lambda: co.retract(state, delta),
            "error (vmap over FK)": lambda: co.error_metric(state, aux),
        }
        line = ", ".join(f"{k} {_synced_ms(f):.3f}" for k, f in stages.items())
        print(f"[ik] batch {b} stages (ms, each synced, mean of 5): {line} on {card}")
        # one iteration behind a one-second sleep kernel: the host returns
        # long before the sleep ends unless the iteration syncs
        carry = opt.run_scan(opt.init_carry(state, aux, opt.opts), aux, 1, opt.opts)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S))
        t0 = time.perf_counter()
        carry = opt.run_scan(carry, aux, 1, opt.opts)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print(f"[ik] one LM iteration enqueued behind a 1 s sleep kernel: the host returned after {host_ms:.2f} ms")
    check(host_ms < 500.0, "IK: the LM iteration waited for the card")
    print(f"[ik] stages done at {time.perf_counter() - t_phase:.1f} s of the phase")

    profiled = {}
    for batch in IK_BATCHES[-1:]:
        targets = ik_targets(fk, robot.dof, batch, torch.float32, dev)
        theta0 = torch.zeros(batch, robot.dof, dtype=torch.float32, device=dev)
        layer.forward({"theta": theta0, "target": targets})
        torch.cuda.synchronize()
        # device activity only: the vmapped autodiff records ~10^5 host ops a
        # call, whose post-processing alone would take seconds
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            layer.forward({"theta": theta0, "target": perturb_targets(targets, 0)})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        profiled[batch] = {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
                           "kernels_per_iter": len(events) / IK_ITERS}
        print(f"[profile] ik7 batch {batch}, one call ({IK_ITERS} LM iterations): wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f} %), {len(events) / IK_ITERS:.0f} device kernels per "
              f"iteration (the initial error included), on {card}")
    return {"rows": rows, "profile": profiled, "f32_vs_f64": {"joint_basins": n_joint, "task_basins": n_task,
                                                             "f64_solved": n_solved, "f32_missed": n_miss}}


def phase_dense_pgo(dev):
    """PGO 64 x 16 (the JAX golden's problem) through the dense
    linearization: the float32 forward with the counters reset just before
    and read just after (the Between kernel linearizes every iteration, via
    dense_A_b; one AtA product and one cholesky_ex solve), its plateau
    against the float64 plain-twin dense solve on the card, and the float64
    kernel solve against the JAX float64 golden."""
    import torch

    from theseus_tpu_torch import _cuda, config

    golden, golden_iters = golden_errors()
    check(golden_iters == ITERS, "golden iteration count changed")
    golden_t = torch.as_tensor(golden)
    g = golden_problem(torch.float32, dev, linearization="dense")
    check(g.opt.linearization == "dense", "dense PGO: not the dense linearization")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    _, info = g.layer.forward(g.inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    print(f"[dense] PGO 64x16 float32 dense forward, {ITERS} LM iterations: {wall:.3f} s wall, mean final err "
          f"{float(info.last_err.mean()):.8e}, launches { {k: v for k, v in launches.items() if v} }")
    want = {k: 0 for k in launches}
    want["between_se3"] = 2 * ITERS + 1  # linearize + tentative error per iteration, + initial error
    for k, v in want.items():
        check(launches[k] == v, f"dense PGO: {k} {launches[k]} launches, expected {v}")
    check(bool(torch.isfinite(info.last_err).all()), "dense PGO: non-finite final error")

    ref = golden_problem(torch.float64, dev, linearization="dense")
    _cuda.reset_launches()
    with config.plain_path():
        _, ref_info = ref.layer.forward(ref.inputs)
    check(sum(_cuda.launches.values()) == 0, "the plain path launched a kernel")
    rel = _rel(info.last_err, ref_info.last_err)
    print(f"[dense] float32 kernels vs float64 plain twins on the card (dense): max rel dev of per-batch final error "
          f"{float(rel.max()):.3e} (tol {PLATEAU_RTOL_F32:.0e})")
    check(float(rel.max()) <= PLATEAU_RTOL_F32, "dense PGO: float32 plateau off the float64 plateau")

    g64 = golden_problem(torch.float64, dev, linearization="dense")
    _, info64 = g64.layer.forward(g64.inputs)
    rel = _rel(info64.last_err, golden_t)
    print(f"[dense] float64 kernels (dense) vs JAX float64 golden: max rel dev {float(rel.max()):.3e} "
          f"(tol {PLATEAU_RTOL_F64:.0e}); mean {float(info64.last_err.mean()):.8e} vs {float(golden.mean()):.8e}")
    check(float(rel.max()) <= PLATEAU_RTOL_F64, "dense PGO: float64 off the JAX golden")
    dense_ms = lm_iter_ms(g)
    print(f"[dense] PGO 64x16 float32 dense LM iteration {dense_ms:.4f} ms (marginal window, as the timing phase)")
    return launches, dense_ms


# ---------------------------------------------------------------------------
# the 2-D pose graph (SE2, block size 3) and the SO3 dense solve
# ---------------------------------------------------------------------------
def manhattan():
    """scripts/manhattan_g2o.py as a module (it imports numpy only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("manhattan_g2o", MANHATTAN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pgo2d_objective(n, poses, edges, meas, w, dtype, dev):
    """An SE2 variable per pose, a Between per edge with a
    DiagonalCostWeight of the first edge's sqrt-information diagonal (the
    generator's graphs carry one information matrix for every edge, as
    M3500), a Local prior on pose 0 with weight 10: (objective, inputs)."""
    import numpy as np

    import theseus_tpu_torch as tt

    w0 = w[0].double().cpu().numpy()
    obj = tt.Objective(dtype=dtype, device=dev)
    xs = [tt.SE2(name=f"pose_{i}") for i in range(n)]
    obj.add(tt.Local(xs[0], poses[0].cpu().numpy(), tt.ScaleCostWeight(10.0), name="prior"))
    weight = tt.DiagonalCostWeight(np.sqrt(np.diag(w0.T @ w0))[None])
    meas = meas.cpu().numpy()  # sliced on the host, stacked once by the compiled objective
    for e, (i, j) in enumerate(edges):
        obj.add(tt.Between(xs[i], xs[j], meas[e], cost_weight=weight, name=f"edge_{e}"))
    return obj, {f"pose_{i}": poses[i] for i in range(n)}


def _device_window(fn):
    """(wall ms, {card index: device busy ms}, {kernel name: (ms, count)}) of
    fn() under torch.profiler (device activity only: the host side of ~3000
    launches an iteration takes the profiler seconds to post-process), the
    wall ended by a sync of every card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = (time.perf_counter() - t0) * 1e3
    busy, by_name = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy[e.device_index] = busy.get(e.device_index, 0.0) + ms
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + ms, k + 1)
    return wall, busy, by_name


def _profile_window(prob, n_iters):
    """(wall ms, device busy ms, device kernels, {kernel name: (ms, count)})
    of n_iters LM iterations (`_device_window`), after two warm ones."""
    import torch

    opt, opts = prob.opt, prob.opt.opts
    with torch.no_grad():
        carry = opt.run_scan(opt.init_carry(prob.state, prob.aux, opts), prob.aux, 2, opts)
        torch.cuda.synchronize()
        wall, busy, by_name = _device_window(lambda: opt.run_scan(carry, prob.aux, n_iters, opts))
    return wall, sum(busy.values()), sum(k for _, k in by_name.values()), by_name


def phase_pgo2d(dev, card):
    """The M3500-sized SE2 pose graph on the sparse level plan at block size
    3, batch 1: scripts/manhattan_g2o.py's graph written to a temporary
    directory and read onto the card (read_2d_g2o, no device named); the
    assembly and level kernels against their twins at this graph's shapes
    (f32, f64); the float32 forward with the counters reset just before and
    read just after; its plateau against the float64 plain-twin solve; the
    float64 kernel solve against that twin and (on the golden's 500-pose
    graph) against the committed JAX golden; symbolic-analysis seconds, the
    LM iteration's ms and idle share; rows 2-4b's times and bounds at d = 3.
    Then mini_2d.g2o on the default dense linearization, and a small dense
    SO3 rotation averaging against its float64 twin."""
    import tempfile

    import numpy as np
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.lie import so3
    from theseus_tpu_torch.lie.utils import draw
    from theseus_tpu_torch.sparse.assemble import assemble
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
    from theseus_tpu_torch.sparse.level_kernels import (
        level_bwd_subst, level_bwd_subst_plain, level_factor, level_factor_plain,
        level_fwd_subst, level_fwd_subst_plain)
    from theseus_tpu_torch.utils.examples.pose_graph import read_2d_g2o

    steps, t_step = {}, [time.perf_counter()]

    def step(name):  # seconds of each part of the phase, printed at its end
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 2)
        t_step[0] = now

    mg = manhattan()
    golden = np.load(PGO2D_GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        path, gpath = Path(tmp) / "manhattan.g2o", Path(tmp) / "golden.g2o"
        mg.write_g2o(path, mg.generate(PGO2D_POSES, PGO2D_SEED))
        mg.write_g2o(gpath, mg.generate(int(golden["n_poses"]), int(golden["seed"])))
        t0 = time.perf_counter()
        graph = read_2d_g2o(path, dtype=torch.float64)  # device None: the card
        read_s = time.perf_counter() - t0
        ggraph = read_2d_g2o(gpath, dtype=torch.float64)
    n, poses, edges, meas, w = graph
    check(poses.device.type == "cuda" and tuple(poses.shape) == (n, 1, 4) and tuple(w.shape) == (len(edges), 3, 3),
          "read_2d_g2o: not on the card or bad shapes")
    print(f"[pgo2d] {MANHATTAN.relative_to(ROOT)} --poses {PGO2D_POSES} --seed {PGO2D_SEED}: {n} poses, "
          f"{len(edges)} edges ({n - 1} odometry, {len(edges) - n + 1} loop closures), read onto {poses.device} "
          f"in {read_s:.3f} s")
    step("generate and read")

    # the float32 objective takes the default ordering ("auto": nested
    # dissection and AMD analysed, the cheaper kept); the float64 one is
    # given the ordering it chose, by name, so the search runs once
    ordering = {}
    for dtype in (torch.float32, torch.float64):
        obj, inputs = pgo2d_objective(*graph, dtype, dev)
        t0 = time.perf_counter()
        obj.compile()
        compile_s = time.perf_counter() - t0
        prob = Problem(obj, inputs, **ordering)
        print(f"[pgo2d] {str(dtype)[6:]}: objective compiled in {compile_s:.3f} s; block pattern, symbolic analysis "
              f"({'auto' if not ordering else 'the float32 ordering'}) and level schedule {prob.builder_s:.3f} s "
              f"on the host")
        if dtype == torch.float32:
            p32 = prob
            ordering = {"ordering": [prob.co.var_names[i] for i in prob.builder.sched.perm]}
        else:
            p64 = prob
    sched, pattern = p32.builder.sched, p32.builder.pattern
    n_levels = len(sched.level_tables)
    check(pattern.d == 3 and sched.tail_k > 0 and n_levels > 1, "pgo2d: not a d = 3 head of levels and a tail")
    check((len(p64.builder.sched.level_tables), p64.builder.sched.tail_k) == (n_levels, sched.tail_k),
          "pgo2d: the float64 schedule differs from the float32 one")
    print(f"[pgo2d] d={pattern.d}: {n_levels} head levels over {sched.n_head} columns, dense tail of "
          f"{sched.tail_k} columns, nnz_L {sched.sym.nnz_l} blocks, longest column "
          f"{int(sched.row_valid.sum(1).max())} block rows, longest update list {int(sched.upd_valid.sum(1).max())}, "
          f"{sum(len(c) <= 4 for c in sched.sym.levels)} levels of at most 4 columns (one block a column at B=1)")
    step("objectives and symbolic analyses")

    # the symbolic analysis of this graph (AMD), through the g++-built
    # native/ library and through its pure-Python twin: seconds of each and
    # equal tables, slot for slot
    from theseus_tpu_torch import native
    from theseus_tpu_torch.sparse.structure import symbolic_factor

    sym_s, tables = {}, {}
    for label, use_native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        sf = symbolic_factor(pattern.n_vars, pattern.pairs, pattern.d, "amd", native=use_native)
        sym_s[label] = time.perf_counter() - t0
        tables[label] = (sf.perm.tolist(), [c.tolist() for c in sf.col_rows], sf.upd_lists,
                         [lv.tolist() for lv in sf.levels], sf.tail_start, sf.block_of)
    same = {k: a == b for k, a, b in zip(("perm", "col_rows", "upd_lists", "levels", "tail_start", "block_of"),
                                         tables["native"], tables["python"])}
    print(f"[pgo2d] symbolic analysis of the {n}-pose graph (AMD, d = 3) on the host: native (g++ -O2, built in "
          f"{native.build_seconds:.2f} s) {sym_s['native']:.3f} s, pure Python {sym_s['python']:.3f} s "
          f"({sym_s['python'] / sym_s['native']:.1f}x); tables equal: {json.dumps(same)}; on {card}")
    check(all(same.values()), f"pgo2d: the native symbolic tables differ from the Python twin's: {same}")
    step("native and Python symbolic analyses")

    # rows 2, 3, 4a and 4b against their twins at this graph's shapes
    max_abs, lv32, sys32 = {}, None, None
    for dn, prob in (("float32", p32), ("float64", p64)):
        system = plain_system(prob)
        padded = padded_blocks(prob)
        got = _repeatable("assemble_blocks", lambda: assemble_blocks(pattern, padded), f"{dn} PGO2D {n}x1")
        max_abs.setdefault("assemble_blocks", {})[dn] = _dev_report(
            "assemble_blocks", dn, got, assemble_blocks_plain(pattern, padded),
            "buckets K=" + ",".join(str(err.shape[0]) for _, err in padded))
        lv = level_inputs(prob, *system[1:])
        note = f"{len(lv)} levels, d=3, B=1"
        for name, k, pl, idx in (("level_factor", level_factor, level_factor_plain, 0),
                                 ("level_fwd_subst", level_fwd_subst, level_fwd_subst_plain, 1),
                                 ("level_bwd_subst", level_bwd_subst, level_bwd_subst_plain, 2)):
            max_abs.setdefault(name, {})[dn] = _dev_report(
                name, dn, [k(*ops[idx]) for ops in lv], [pl(*ops[idx]) for ops in lv], note)
        if dn == "float32":
            lv32, sys32, padded32 = lv, system, padded
    step("kernels against twins")

    # the main path: the float32 forward, counters around it only
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with mock.patch("torch.linalg.cholesky_ex", wraps=torch.linalg.cholesky_ex) as potrf:
        t0 = time.perf_counter()
        out, info = p32.layer.forward(p32.inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    print(f"[pgo2d] {n}x1 float32 forward, {ITERS} LM iterations: {wall:.3f} s wall, error "
          f"{float(info.err_history[0, 0]):.8e} -> {float(info.last_err[0]):.8e}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, cholesky_ex {potrf.call_count}")
    expect = {k: 0 for k in launches}
    expect.update({"assemble_blocks": ITERS, "level_factor": ITERS * n_levels,
                   "level_fwd_subst": ITERS * n_levels, "level_bwd_subst": ITERS * n_levels,
                   "tail_update": ITERS})
    for k, v in expect.items():
        check(launches[k] == v, f"pgo2d: {k} {launches[k]} launches, expected {v}")
    check(potrf.call_count == ITERS, f"pgo2d: {potrf.call_count} cholesky_ex calls for {ITERS} factorizations")
    check(bool(torch.isfinite(info.last_err).all()), "pgo2d: non-finite final error")
    check(all(tuple(t.shape) == (1, 4) and bool(torch.isfinite(t).all())
              for k, t in out.items() if k.startswith("pose_")), "pgo2d: bad output poses")
    step("float32 forward")

    # float64: the plain twins on the card, then the kernels
    _cuda.reset_launches()
    with config.plain_path():
        _, ref = p64.layer.forward(p64.inputs)
    check(sum(_cuda.launches.values()) == 0, "the plain path launched a kernel")
    _, info64 = p64.layer.forward(p64.inputs)
    hist = ref.err_history[:, 0]
    plateau = abs(float(hist[ITERS - 5]) - float(hist[ITERS])) / float(hist[ITERS])
    print(f"[pgo2d] float64 plain twins: error {float(hist[0]):.8e} -> {float(hist[ITERS]):.12e}, converged at "
          f"iteration {int(ref.converged_iter[0])}; change over the last 5 iterations {plateau:.3e} "
          f"(plateau tol {PLATEAU_RTOL_F64:.0e})")
    check(plateau <= PLATEAU_RTOL_F64, "pgo2d: the float64 solve is not on its plateau after ITERS iterations")
    rel32, rel64 = float(_rel(info.last_err, ref.last_err).max()), float(_rel(info64.last_err, ref.last_err).max())
    print(f"[pgo2d] float32 kernels vs float64 plain twins: rel dev of the final error {rel32:.3e} "
          f"(tol {PLATEAU_RTOL_F32:.0e}); float64 kernels vs float64 plain twins {rel64:.3e} "
          f"(tol {PLATEAU_RTOL_F64:.0e})")
    check(rel32 <= PLATEAU_RTOL_F32, "pgo2d: float32 plateau off the float64 plateau")
    check(rel64 <= PLATEAU_RTOL_F64, "pgo2d: float64 kernels off the float64 twins")
    step("float64 twin and kernel solves")

    gn = ggraph[0]
    gobj, ginputs = pgo2d_objective(*ggraph, torch.float64, dev)
    gprob = Problem(gobj, ginputs)
    gout, ginfo = gprob.layer.forward(ginputs)
    rel = abs(float(ginfo.last_err[0]) - float(golden["last_err"][0])) / float(golden["last_err"][0])
    pose_dev = float(np.abs(np.stack([gout[f"pose_{i}"][0].cpu().numpy() for i in range(gn)]) - golden["poses"]).max())
    print(f"[pgo2d] golden graph ({gn} poses, seed {int(golden['seed'])}) float64 kernels vs JAX float64 golden: "
          f"final error {float(ginfo.last_err[0]):.12e} vs {float(golden['last_err'][0]):.12e}, rel {rel:.3e} "
          f"(tol {PLATEAU_RTOL_F64:.0e}); max pose deviation {pose_dev:.3e}")
    check(rel <= PLATEAU_RTOL_F64, "pgo2d: float64 off the JAX golden")
    step("JAX golden")

    # host cost and idle share of one LM iteration, float32
    iter_ms = lm_iter_ms(p32, n_small=2, extra=10, reps=2)
    pwall, busy, kernels, by_name = _profile_window(p32, 2)
    idle = 1.0 - busy / pwall
    print(f"[pgo2d] {n}x1 float32 LM iteration {iter_ms:.4f} ms (marginal window); profiler, 2 iterations: wall "
          f"{pwall:.2f} ms, device busy {busy:.2f} ms (idle {100 * idle:.1f} %), {kernels / 2:.0f} device kernels "
          f"an iteration, on {card}")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"[pgo2d]   {t / 2:8.3f} ms an iteration  {k // 2:5d}x  {name[:90]}")
    step("LM iteration and profile")
    with torch.no_grad():
        state, aux, opts = p32.state, p32.aux, p32.opt.opts
        blocks = p32.co.linearize_blocks(state, aux)
        ns = p32.builder.build(state, aux)
        delta, _ = ns.solve(1e-3, opts.ellipsoidal_damping)
        stages = {
            "linearize": lambda: p32.co.linearize_blocks(state, aux),
            "assemble": lambda: assemble(pattern, blocks),
            "solve": lambda: ns.solve(1e-3, opts.ellipsoidal_damping),
            "retract": lambda: p32.co.retract(state, delta),
            "error": lambda: p32.co.error_metric(state, aux),
        }
        print(f"[pgo2d] stages (ms, each synced, mean of 3): "
              + ", ".join(f"{k} {_synced_ms(f, reps=3):.3f}" for k, f in stages.items()) + f" on {card}")

    # rows 2-4b at d = 3, float32: one assembly and one sweep of each level kernel
    _, ata, lflat, y, x, b_perm = sys32
    fns = {
        "assemble_blocks": (lambda: assemble_blocks(pattern, padded32), lambda: assemble_blocks_plain(pattern, padded32)),
        "level_factor": (lambda: [level_factor(*f) for f, _, _ in lv32],
                         lambda: [level_factor_plain(*f) for f, _, _ in lv32]),
        "level_fwd_subst": (lambda: [level_fwd_subst(*fw) for _, fw, _ in lv32],
                            lambda: [level_fwd_subst_plain(*fw) for _, fw, _ in lv32]),
        "level_bwd_subst": (lambda: [level_bwd_subst(*bw) for _, _, bw in lv32],
                            lambda: [level_bwd_subst_plain(*bw) for _, _, bw in lv32]),
    }
    # few reps: a sweep is 92 launches, and the launch queue (about 1024
    # entries) must hold every timed call behind device_ms's sleep kernel
    times = {k: (cuda_ms(kern, reps=5), cuda_ms(plain, reps=3, warmup=1), device_ms(kern, reps=3, warmup=1))
             for k, (kern, plain) in fns.items()}
    bounds = {
        "assemble_blocks": assembly_bound(pattern, padded32),
        "level_factor": _bound(sum(_nbytes(*f) + _nbytes(f[0]) for f, _, _ in lv32), factor_flops(sched, 1, 3)),
        "level_fwd_subst": _bound(sum(_nbytes(*fw) + _nbytes(fw[2]) for _, fw, _ in lv32),
                                  subst_flops(sched, 1, 3, True)),
        "level_bwd_subst": _bound(sum(_nbytes(*bw) + _nbytes(bw[2]) for _, _, bw in lv32),
                                  subst_flops(sched, 1, 3, False)),
    }
    # where a sweep's device time goes: each level's launch alone
    for name, kern, idx in (("level_factor", level_factor, 0), ("level_bwd_subst", level_bwd_subst, 2)):
        per = [(device_ms(lambda ops=ops: kern(*ops[idx]), reps=3, warmup=1), ops[0][0].shape[0],
                ops[0][0].shape[1], ops[0][1].shape[1]) for ops in lv32]
        total = sum(p[0] for p in per)
        top = sorted(per, reverse=True)[:5]
        print(f"[pgo2d] {name} per level, device ms (C, rl, ul), the 5 slowest of {len(per)}: "
              + ", ".join(f"{t:.4f} ({c}, {rl}, {ul})" for t, c, rl, ul in top)
              + f"; they are {100 * sum(p[0] for p in top) / total:.1f} % of the {total:.4f} ms summed over levels")
    # library yardsticks on the dense H (head and tail, 3 n x 3 n): timed here only
    h = dense_h(pattern, ata)
    l_dense = torch.linalg.cholesky_ex(h)[0]
    rhs = p32.builder.flatten(b_perm[sched.on(dev)[1]])[..., None]
    library = {
        "level_factor": cuda_ms(lambda: torch.linalg.cholesky_ex(h), reps=3),
        "level_fwd_subst": cuda_ms(lambda: torch.linalg.solve_triangular(l_dense, rhs, upper=False), reps=3),
        "level_bwd_subst": cuda_ms(
            lambda: torch.linalg.solve_triangular(l_dense.transpose(-1, -2), rhs, upper=True), reps=3),
    }
    del h, l_dense
    for k, (ms, plain_ms, dev_ms) in times.items():
        bms, by = bounds[k]
        lib = f"{library[k]:.4f} ms" if k in library else "none"
        print(f"[pgo2d] {k:<16} d=3 B=1 float32 ({'one call' if k == 'assemble_blocks' else f'one sweep, {n_levels} launches'}): "
              f"kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms device, plain twin {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), library {lib} on {card}")
    step("timing")

    # mini_2d.g2o on the default dense linearization, float64
    m = read_2d_g2o(G2O_2D, dtype=torch.float64)
    shift = torch.tensor(MINI_2D_SHIFT, dtype=torch.float64, device=m[1].device)
    moved = torch.cat([m[1][:1], tt.lie.SE2.retract(m[1][1:], shift)])
    mobj, minputs = pgo2d_objective(m[0], moved, m[2], m[3], m[4], torch.float64, dev)
    mopt = tt.LevenbergMarquardt(mobj, max_iterations=15, adaptive_damping=True)
    check(mopt.linearization == "dense" and m[1].device.type == "cuda", "mini_2d: not dense or not on the card")
    _, minfo = tt.TheseusLayer(mopt).forward(minputs)
    first, last = float(minfo.err_history[0, 0]), float(minfo.last_err[0])
    print(f"[pgo2d] {G2O_2D.relative_to(ROOT)} (poses 1, 2 moved by {MINI_2D_SHIFT}) float64 dense LM on "
          f"{m[1].device}: error {first:.6e} -> {last:.3e} (tol 1e-10)")
    check(first > 1e-3 and last < 1e-10, "mini_2d: the graph did not solve to zero error")
    step("mini_2d")

    # rotation averaging on SO3 (dense), from rand_so3 with no device named
    gen = torch.Generator().manual_seed(0)
    gt = tt.rand_so3(SO3_ROT * SO3_BATCH, generator=gen, dtype=torch.float64).tensor
    check(gt.device.type == "cuda", "rand_so3 did not land on the card")
    gt = gt.reshape(SO3_ROT, SO3_BATCH, 3, 3)
    pairs = [(i, i + 1) for i in range(SO3_ROT - 1)] + [(i, i + 2) for i in range(SO3_ROT - 2)]
    e = torch.as_tensor(pairs, device=dev)
    noise = lambda k, s: so3.exp(s * draw(True, (k, SO3_BATCH, 3), gen, torch.float64, dev))  # noqa: E731
    rmeas = so3.compose(so3.compose(so3.inverse(gt[e[:, 0]]), gt[e[:, 1]]), noise(len(pairs), 0.05))
    rinit = so3.compose(gt, noise(SO3_ROT, 0.3))

    def rot_avg(dtype, plain):
        obj = tt.Objective(dtype=dtype, device=dev)
        fam = tt.SO3Family(SO3_ROT, name="rot")
        obj.add(tt.Local(fam[0], gt[0], tt.ScaleCostWeight(10.0), name="anchor"))
        for k, (i, j) in enumerate(pairs):
            obj.add(tt.Between(fam[i], fam[j], rmeas[k], name=f"rel_{k}"))
        layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True))
        with config.plain_path() if plain else contextlib.nullcontext():
            return layer.forward({"rot": rinit.to(dtype)})[1]

    r32, r64 = rot_avg(torch.float32, False), rot_avg(torch.float64, True)
    rel = float(_rel(r32.last_err, r64.last_err).max())
    print(f"[pgo2d] SO3 rotation averaging ({SO3_ROT} rotations x batch {SO3_BATCH}, {len(pairs)} relative "
          f"rotations, dense): float64 error {float(r64.err_history[0].mean()):.6e} -> "
          f"{float(r64.last_err.mean()):.8e}; float32 vs float64 twin rel dev {rel:.3e} (tol {PLATEAU_RTOL_F32:.0e})")
    check(float(r64.last_err.max()) < 0.1 * float(r64.err_history[0].min()), "SO3: the solve did not reduce the error")
    check(rel <= PLATEAU_RTOL_F32, "SO3: float32 plateau off the float64 twin")
    step("SO3")
    print(f"[pgo2d] seconds: {json.dumps(steps)}")
    stats = {"max_abs": max_abs, "times": times, "bounds": bounds, "library": library, "lm_iter_ms": iter_ms,
             "idle": idle, "levels": n_levels, "symbolic_s": sym_s}
    return launches, stats


# ---------------------------------------------------------------------------
# the planning path (GPMP2 motion planning, block size 2)
# ---------------------------------------------------------------------------
def planning_inputs(planner, maps, dtype, dev, lo=0, hi=None):
    """The planner's inputs for maps[lo:hi] (sdf, start, goal numpy) on the
    card: the straight-line initialization and the map inputs."""
    import torch

    sdf, start, goal = (m[lo:hi] for m in maps)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    b = len(sdf)
    inputs = dict(planner.straight_line_initialization(t(start), t(goal)))
    inputs.update(start=t(start), goal=t(goal), sdf_origin=torch.zeros((b, 2), dtype=dtype, device=dev),
                  sdf_data=t(sdf), cell_size=torch.full((b, 1), PLAN_CELL, dtype=dtype, device=dev))
    return inputs


def make_planner(dtype, cls="LevenbergMarquardt", iters=PLAN_ITERS, linearization="sparse"):
    """The planner on the card (no device named: the default)."""
    import numpy as np

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.motion_planning import MotionPlanner

    kw = {"adaptive_damping": True} if cls == "LevenbergMarquardt" else {}
    return MotionPlanner(PLAN_MAP, PLAN_EPS, PLAN_TIME, PLAN_CW, np.eye(2), PLAN_STEPS,
                         optimizer_cls=getattr(tt, cls), max_iterations=iters, dtype=dtype,
                         linearization=linearization, **kw)


def _plan(planner, inputs, plain=False, **kwargs):
    from theseus_tpu_torch import config

    with config.plain_path() if plain else contextlib.nullcontext():
        return planner.layer.forward(inputs, optimizer_kwargs=kwargs)


def _plateau_report(label, info32, ref, held=(0,)):
    """Float32 final errors against a float64 reference, per element. The
    planner's problem is nonconvex (the collision hinge over a bilinear
    SDF) and ill-conditioned, and float32's rounding sends a trajectory
    that is caught against obstacles into another local minimum, lower or
    higher: PLATEAU_RTOL_F32 is held on the elements `held` (element 0 is
    the batch-1 problem, map 0, whose solve converges in a few iterations),
    the whole batch is printed: the share within the tolerance, the share
    where float32 ends lower, the worst, and the batch means."""
    import torch

    check(bool(torch.isfinite(info32.last_err).all()), f"{label}: non-finite float32 error")
    check(bool((info32.last_err <= info32.err_history[0]).all()), f"{label}: float32 ended above its start")
    rel = _rel(info32.last_err, ref.last_err)
    lower = info32.last_err.double().cpu() < ref.last_err.double().cpu()
    idx = torch.as_tensor(held)
    worst_held = float(rel[idx].max())
    print(f"[planning] {label}: float32 kernels vs float64 twins, rel dev of the final error on elements "
          f"{list(held)} {worst_held:.3e} (tol {PLATEAU_RTOL_F32:.0e}); over all {len(rel)}: "
          f"{int((rel <= PLATEAU_RTOL_F32).sum())} within the tol, median {float(rel.median()):.3e}, max "
          f"{float(rel.max()):.3e}, float32 lower on {int(lower.sum())}; mean final error float32 "
          f"{float(info32.last_err.double().mean()):.6e}, float64 {float(ref.last_err.double().mean()):.6e}")
    check(worst_held <= PLATEAU_RTOL_F32, f"{label}: float32 off the float64 plateau by {worst_held:.3e}")


def _f64_report(label, info, ref, tol=PLATEAU_RTOL_F64):
    rel = float(_rel(info.last_err, ref.last_err).max())
    print(f"[planning] {label}: rel dev of the final error {rel:.3e} (tol {tol:.0e})")
    check(rel <= tol, f"{label}: {rel:.3e} > {tol}")


def _learn_grad(dtype, dev, maps, plain=False):
    """One outer step: the initial-trajectory model's gradient of the mean
    final error after PLAN_LEARN_ITERS unrolled LM iterations.
    Returns (loss, flat gradient, forward launches, backward launches)."""
    import torch

    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.utils.examples.motion_planning import InitialTrajectoryModel

    planner = make_planner(dtype, iters=PLAN_LEARN_ITERS)
    model = InitialTrajectoryModel(PLAN_STEPS, generator=torch.Generator().manual_seed(0), dtype=dtype, device=dev)
    inputs = planning_inputs(planner, maps, dtype, dev, 0, PLAN_LEARN_BATCH)
    with config.plain_path() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        _cuda.reset_launches()
        inputs.update(model(inputs["start"], inputs["goal"], PLAN_TIME))
        _, info = planner.layer.forward(inputs, optimizer_kwargs={"backward_mode": "unroll"})
        loss = info.last_err.mean()
        torch.cuda.synchronize()
        fwd = dict(_cuda.launches)
        _cuda.reset_launches()
        loss.backward()
        torch.cuda.synchronize()
        bwd = dict(_cuda.launches)
    grad = torch.cat([p.grad.reshape(-1).double() for p in model.parameters()])
    return loss.item(), grad, fwd, bwd


def _plan_cond(pattern, ata):
    """The largest condition number over the batch of the block matrix
    (diagonal blocks symmetrised), from its eigenvalues in float64."""
    import torch

    ev = torch.linalg.eigvalsh(dense_h(pattern, ata.double()))
    return float((ev[:, -1] / ev[:, 0]).max())


def _maybe_plain(plain, fn, *args):
    from theseus_tpu_torch import config

    with config.plain_path() if plain else contextlib.nullcontext():
        return fn(*args)


def _plan_report(name, dn, got, twin, ref, cond, note):
    """A kernel at the planner's shapes against its twin. float64: the
    default tolerance (_dev_report). float32: the planner's block matrix is
    ill-conditioned (cond, printed, ~1e7), and two correct float32
    implementations that round in another order differ by more than the
    default (the factor's 2x2 pivots cancel): held to be as accurate as its
    twin, its deviation from the twin evaluated in float64 on the same
    inputs at most twice the float32 twin's plus the default tolerance,
    relative to max(1, |twin|). Returns max |kernel - twin|."""
    import torch

    if ref is None:
        print(f"[kernel] {name:<15} {dn} {note}: cond {cond:.3e}")
        return _dev_report(name, dn, got, twin, note)
    scale = max([1.0] + [float(w.abs().max()) for w in twin])
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name} {dn} {note}: non-finite kernel output")
    dev = max(float((g - w).abs().max()) for g, w in zip(got, twin))
    default = KERNEL_TOL[dn]["default"]
    ek = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref)) / scale
    et = max(float((w.double() - r).abs().max()) for w, r in zip(twin, ref)) / scale
    ok = ek <= 2.0 * et + default
    print(f"[kernel] {name:<15} {dn} {note:<12} cond {cond:.3e}: max_abs={dev:.3e} vs twin; relative to "
          f"max(1,|twin|), error against the float64 twin: kernel {ek:.3e}, float32 twin {et:.3e} "
          f"(held: kernel <= 2 x twin + {default:.0e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {dn} {note}: kernel error {ek:.3e} against float64 exceeds 2 x the twin's {et:.3e} + {default}")
    return dev


def phase_planning(dev, card):
    """GPMP2 motion planning at the reference's size on the sparse level plan
    at block size 2: kernels against twins at the planner's shapes, the
    float32 forward at batch 1 and 64 with the counters around each, the
    float32 and float64 plateaus, dense and whole-sweep plans, Dogleg,
    compute_samples, compute_covariances, one learned-initialization step,
    timings."""
    import numpy as np
    import torch

    from theseus_tpu_torch import _cuda, config
    from theseus_tpu_torch.sparse.assemble import assemble
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
    from theseus_tpu_torch.sparse.cholesky import factorize, sample_with_factor
    from theseus_tpu_torch.sparse.level_kernels import (
        level_bwd_subst, level_bwd_subst_plain, level_factor, level_factor_plain,
        level_fwd_subst, level_fwd_subst_plain)
    from theseus_tpu_torch.sparse.whole import whole_bwd_subst, whole_factor, whole_fwd_subst
    from theseus_tpu_torch.utils.examples.motion_planning import synthetic_maps

    steps, t_step = {}, [time.perf_counter()]

    def step(name):  # seconds of each part of the phase, printed at its end
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 2)
        t_step[0] = now

    bmax = max(PLAN_BATCHES)
    maps = synthetic_maps(bmax, PLAN_MAP, PLAN_CELL, seed=PLAN_SEED)
    print(f"[planning] {bmax} maps {PLAN_MAP}x{PLAN_MAP} (cell {PLAN_CELL} m) from seed {PLAN_SEED}: "
          f"{100 * float((maps[0] < 0).mean()):.1f} % occupied; start {maps[1][0].tolist()}, goal {maps[2][0].tolist()}")
    planners = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        pl = make_planner(dtype)
        pl.objective.compile()
        t1 = time.perf_counter()
        _ = pl.optimizer.normal_builder
        planners[dtype] = pl
        print(f"[planning] {str(dtype)[6:]}: objective compiled in {t1 - t0:.3f} s; block pattern, symbolic "
              f"analysis (auto ordering) and level schedule {time.perf_counter() - t1:.3f} s on the host")
    p32, p64 = planners[torch.float32], planners[torch.float64]
    bld = p32.optimizer.normal_builder
    sched, pattern = bld.sched, bld.pattern
    n_levels = len(sched.level_tables)
    check(pattern.d == 2 and pattern.n_vars == 2 * (PLAN_STEPS + 1) and n_levels > 1,
          "planning: not 202 variables at block size 2 over levels")
    whole_ok = sched.tail_k == 0
    print(f"[planning] d={pattern.d}, {pattern.n_vars} variables: {n_levels} head levels over {sched.n_head} "
          f"columns, dense tail of {sched.tail_k} columns, nnz_L {sched.sym.nnz_l} blocks; (C, rl, ul) per level "
          + " ".join(f"({len(t['cols'])},{t['row_valid'].shape[1]},{t['upd_valid'].shape[1]})"
                     for t in sched.level_tables)
          + f"; the whole-sweep plan {'takes' if whole_ok else 'does not take'} this schedule")
    step("maps, objectives and symbolic analyses")

    # every kernel at the planner's shapes against its twin, twice for the bits
    max_abs, sys_by, lv_by, padded_by, probs = {}, {}, {}, {}, {}
    for dn, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        for b in PLAN_BATCHES:
            prob = Problem(planners[dtype].objective, planning_inputs(planners[dtype], maps, dtype, dev, 0, b),
                           iters=PLAN_ITERS)
            check(len(prob.builder.sched.level_tables) == n_levels, "planning: another schedule for the same graph")
            pattern_b, sched_b = prob.builder.pattern, prob.builder.sched
            system = plain_system(prob)
            padded = padded_blocks(prob)
            lv = level_inputs(prob, *system[1:])
            _, ata, _, _, _, b_perm = system
            atb = b_perm[sched_b.on(dev)[1]]
            cond = _plan_cond(pattern_b, ata)
            with config.plain_path():
                lflat_p = whole_factor(sched_b, ata)
                y_p = whole_fwd_subst(sched_b, lflat_p, atb)

            def whole(fn, *args):
                return lambda cast, plain: [_maybe_plain(plain, fn, sched_b, *[cast(a) for a in args])]

            runs = {
                "assemble_blocks": lambda cast, plain: list(
                    (assemble_blocks_plain if plain else assemble_blocks)(
                        pattern_b, [([cast(j) for j in jacs], cast(e)) for jacs, e in padded])),
                **{name: (lambda cast, plain, k=k, pl=pl, idx=idx:
                          [(pl if plain else k)(*[cast(t) for t in ops[idx]]) for ops in lv])
                   for name, k, pl, idx in (("level_factor", level_factor, level_factor_plain, 0),
                                            ("level_fwd_subst", level_fwd_subst, level_fwd_subst_plain, 1),
                                            ("level_bwd_subst", level_bwd_subst, level_bwd_subst_plain, 2))},
            }
            if whole_ok:
                runs.update({"whole_factor": whole(whole_factor, ata),
                             "whole_fwd_subst": whole(whole_fwd_subst, lflat_p, atb),
                             "whole_bwd_subst": whole(whole_bwd_subst, lflat_p, y_p)})
            for name, run in runs.items():
                got = _repeatable(name, lambda run=run: run(lambda t: t, False), f"{dn} plan B={b}")
                twin = run(lambda t: t, True)
                ref = run(lambda t: t.double(), True) if dtype == torch.float32 else None
                e = _plan_report(name, dn, got, twin, ref, cond, f"plan d=2 B={b}")
                max_abs.setdefault(name, {}).setdefault(dn, 0.0)
                max_abs[name][dn] = max(max_abs[name][dn], e)
            if dn == "float32":
                sys_by[b], lv_by[b], padded_by[b], probs[b] = system, lv, padded, prob
    step("kernels against twins")

    # the main path: float32 forwards, the counters reset just before and read just after each
    launches = {k: 0 for k in _cuda.launches}
    outs, infos = {}, {}
    expect = {k: 0 for k in _cuda.launches}
    expect.update({"assemble_blocks": PLAN_ITERS, "level_factor": PLAN_ITERS * n_levels,
                   "level_fwd_subst": PLAN_ITERS * n_levels, "level_bwd_subst": PLAN_ITERS * n_levels,
                   "tail_update": PLAN_ITERS if sched.tail_k else 0})
    for b in PLAN_BATCHES:
        inputs = planning_inputs(p32, maps, torch.float32, dev, 0, b)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        outs[b], infos[b] = p32.solve(inputs["start"], inputs["goal"], inputs["sdf_origin"], inputs["sdf_data"],
                                      inputs["cell_size"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_cuda.launches)
        for k in launches:
            launches[k] += got[k]
        traj = p32.trajectory(outs[b])
        print(f"[planning] B={b} float32 forward, {PLAN_ITERS} LM iterations (level plan): {wall:.3f} s wall, mean "
              f"error {float(infos[b].err_history[0].mean()):.6e} -> {float(infos[b].last_err.mean()):.6e}, "
              f"launches { {k: v for k, v in got.items() if v} }")
        for k, v in expect.items():
            check(got[k] == v, f"planning B={b}: {k} {got[k]} launches, expected {v}")
        check(tuple(traj.shape) == (b, PLAN_STEPS + 1, 2) and bool(torch.isfinite(traj).all()),
              f"planning B={b}: bad trajectory")
    step("float32 forwards")

    # float64: the plain twins on the card, the kernels, dense, whole
    _cuda.reset_launches()
    in64 = planning_inputs(p64, maps, torch.float64, dev)
    _, ref = _plan(p64, in64, plain=True)
    check(sum(_cuda.launches.values()) == 0, "planning: the plain path launched a kernel")
    hist = ref.err_history.double().cpu()
    print(f"[planning] B={bmax} float64 plain twins: mean error {float(hist[0].mean()):.8e} -> "
          f"{float(hist[-1].mean()):.12e}; per element {np.array2string(hist[-1].numpy(), precision=4)}")
    _plateau_report(f"B={bmax}", infos[bmax], ref)
    one = type(ref)(*(None if t is None else t[..., :1] for t in ref))  # element 0 is the B=1 problem
    _plateau_report("B=1", infos[1], one)
    out64, info64 = _plan(p64, in64)
    _f64_report(f"B={bmax} float64 kernels vs float64 twins", info64, ref)
    dense = make_planner(torch.float64, linearization="dense")
    _, dinfo = _plan(dense, planning_inputs(dense, maps, torch.float64, dev))
    _f64_report(f"B={bmax} float64 dense vs float64 sparse twins", dinfo, ref)
    step("float64 twins, kernels, dense")
    whole_launches, whole_s = {}, None
    if whole_ok:
        config.set_whole_sweep(True)
        try:
            inputs = planning_inputs(p32, maps, torch.float32, dev)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            _, winfo = _plan(p32, inputs)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            whole_launches = dict(_cuda.launches)
            _, winfo64 = _plan(p64, in64)
        finally:
            config.set_whole_sweep(False)
        print(f"[planning] B={bmax} float32 forward on the whole-sweep plan: {whole_s:.3f} s wall, launches "
              f"{ {k: v for k, v in whole_launches.items() if v} }")
        wexpect = {k: 0 for k in whole_launches}
        wexpect.update({"assemble_blocks": PLAN_ITERS, "whole_factor": PLAN_ITERS, "whole_fwd_subst": PLAN_ITERS,
                        "whole_bwd_subst": PLAN_ITERS})
        for k, v in wexpect.items():
            check(whole_launches[k] == v, f"planning whole plan: {k} {whole_launches[k]} launches, expected {v}")
        _plateau_report(f"B={bmax} whole plan", winfo, ref)
        _f64_report(f"B={bmax} float64 whole-sweep kernels vs float64 twins", winfo64, ref)
    step("whole-sweep plan")

    # Dogleg on the sparse path against its own float64 twin solve
    dl32, dl64 = make_planner(torch.float32, "Dogleg"), make_planner(torch.float64, "Dogleg")
    _cuda.reset_launches()
    _, dinfo32 = _plan(dl32, planning_inputs(dl32, maps, torch.float32, dev))
    dl_launches = dict(_cuda.launches)
    _, dref = _plan(dl64, in64, plain=True)
    _, dinfo64 = _plan(dl64, in64)
    print(f"[planning] Dogleg B={bmax}: float64 twins mean error {float(dref.last_err.mean()):.8e}, launches "
          f"(float32) { {k: v for k, v in dl_launches.items() if v} }")
    check(dl_launches["level_factor"] == PLAN_ITERS * n_levels, "Dogleg: level kernels not launched")
    _plateau_report(f"Dogleg B={bmax}", dinfo32, dref)
    _f64_report(f"Dogleg B={bmax} float64 kernels vs float64 twins", dinfo64, dref)
    step("Dogleg")

    # compute_samples on the float32 solution; the row-4b kernel on the same y
    gen = torch.Generator().manual_seed(PLAN_SEED)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    samples, s_ms = once_ms(lambda: p32.layer.compute_samples(values=outs[bmax], n_samples=PLAN_SAMPLES,
                                                             generator=gen))
    s_launches = dict(_cuda.launches)
    st = samples[f"pose_{PLAN_STEPS // 2}"]
    check(tuple(st.shape) == (bmax, PLAN_SAMPLES, 2) and bool(torch.isfinite(st).all()), "compute_samples: bad samples")
    check(s_launches["level_bwd_subst"] == 2 * n_levels and s_launches["level_factor"] == 2 * n_levels,
          f"compute_samples: launches {s_launches}")
    print(f"[planning] compute_samples ({PLAN_SAMPLES} samples, B={bmax}, float32): {s_ms:.3f} ms, launches "
          f"{ {k: v for k, v in s_launches.items() if v} } (one solve for the mean, one factorization and one "
          f"backward sweep for all samples); mid-trajectory pose sample spread {float(st.std(dim=1).mean()):.4e} m")
    for dn, dtype, planner in (("float32", torch.float32, p32), ("float64", torch.float64, p64)):
        vals = outs[bmax] if dtype == torch.float32 else out64
        co = planner.objective.compile()
        v = planner.objective.default_values(vals)
        state, aux = co.pack(v, bmax), co.build_aux(v, bmax)
        nb = planner.optimizer.normal_builder
        ns = nb.build(state, aux)
        lflat = factorize(nb.sched, ns.ata).repeat(1, PLAN_SAMPLES, 1, 1)
        y = torch.randn((pattern.n_vars, PLAN_SAMPLES * bmax, 2), generator=gen, dtype=dtype).to(dev)
        got = _repeatable("level_bwd_subst", lambda: [sample_with_factor(nb.sched, lflat, y)],
                          f"{dn} samples B={bmax}x{PLAN_SAMPLES}")
        with config.plain_path():
            twin = [sample_with_factor(nb.sched, lflat, y)]
            ref = [sample_with_factor(nb.sched, lflat.double(), y.double())] if dtype == torch.float32 else None
        e = _plan_report("level_bwd_subst", dn, got, twin, ref, _plan_cond(nb.pattern, ns.ata),
                         f"samples S={PLAN_SAMPLES}")
        max_abs["level_bwd_subst"][dn] = max(max_abs["level_bwd_subst"][dn], e)
    step("compute_samples")

    # compute_covariances of every 10th pose: sparse (the level kernels) against dense, float64
    names = [f"pose_{i}" for i in range(0, PLAN_STEPS + 1, PLAN_COV_EVERY)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    cov, c_ms = once_ms(lambda: p64.layer.compute_covariances(values=out64, var_names=names))
    c_launches = dict(_cuda.launches)
    dcov = dense.layer.compute_covariances(values=out64, var_names=names)
    worst = max(float((cov[n] - dcov[n]).abs().max()) / float(dcov[n].abs().max()) for n in names)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    _, c32_ms = once_ms(lambda: p32.layer.compute_covariances(values=outs[bmax], var_names=names))
    print(f"[planning] compute_covariances of {len(names)} poses at B={bmax}: float64 sparse {c_ms:.3f} ms "
          f"(float32 {c32_ms:.3f} ms), launches { {k: v for k, v in c_launches.items() if v} }; sparse vs dense "
          f"max rel dev {worst:.3e} (tol {PLATEAU_RTOL_F64:.0e}), no ridge")
    check(c_launches["level_factor"] == n_levels and c_launches["level_fwd_subst"] == len(names) * n_levels
          and c_launches["level_bwd_subst"] == len(names) * n_levels, f"compute_covariances: launches {c_launches}")
    check(worst <= PLATEAU_RTOL_F64, f"compute_covariances: sparse off dense by {worst:.3e}")
    step("compute_covariances")

    # one outer step of the learned initialization
    t0 = time.perf_counter()
    l32, g32, fwd_l, bwd_l = _learn_grad(torch.float32, dev, maps)
    learn_s = time.perf_counter() - t0
    l64p, g64p, _, _ = _learn_grad(torch.float64, dev, maps, plain=True)
    l64, g64, _, _ = _learn_grad(torch.float64, dev, maps)
    rel32 = float((g32 - g64p).norm() / g64p.norm())
    cos32 = float((g32 * g64p).sum() / (g32.norm() * g64p.norm()))
    rel64 = float((g64 - g64p).norm() / g64p.norm())
    print(f"[planning] learned initialization, B={PLAN_LEARN_BATCH}, {PLAN_LEARN_ITERS} unrolled LM iterations: "
          f"float32 step {learn_s:.3f} s, loss {l32:.6e} (float64 twins {l64p:.6e}); forward launches "
          f"{ {k: v for k, v in fwd_l.items() if v} }, backward() launches { {k: v for k, v in bwd_l.items() if v} }; "
          f"float32 gradient vs float64 twins: norm-rel {rel32:.3e} (tol {PLAN_GRAD_RTOL_F32}), cosine {cos32:.6f} "
          f"(min {PLAN_GRAD_COS_F32}); float64 kernels vs twins {rel64:.3e} (tol {GRAD_RTOL_F64:.0e})")
    check(bool(torch.isfinite(g32).all()) and float(g32.norm()) > 0, "learned step: bad float32 gradient")
    check(fwd_l["level_factor"] == PLAN_LEARN_ITERS * n_levels and fwd_l["assemble_blocks"] == PLAN_LEARN_ITERS,
          f"learned step: forward launches {fwd_l}")
    check(rel32 <= PLAN_GRAD_RTOL_F32 and cos32 >= PLAN_GRAD_COS_F32, "learned step: float32 gradient off")
    check(rel64 <= GRAD_RTOL_F64, f"learned step: float64 kernels off the twins by {rel64:.3e}")
    step("learned initialization")

    # ms per planning call and plans/s, fresh maps per call, a sync at the end of each
    serving = {}
    for b in PLAN_BATCHES:
        fresh = [synthetic_maps(b, PLAN_MAP, PLAN_CELL, seed=PLAN_SEED + 1 + r) for r in range(PLAN_REQUESTS + 1)]
        ms = []
        for r, m in enumerate(fresh):
            inputs = planning_inputs(p32, m, torch.float32, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = p32.solve(inputs["start"], inputs["goal"], inputs["sdf_origin"], inputs["sdf_data"],
                                inputs["cell_size"])
            float(info.last_err.sum())  # the answer on the host
            if r:  # the first call warms the per-shape tables
                ms.append((time.perf_counter() - t0) * 1e3)
        serving[b] = {"ms_per_call": ms, "plans_per_s": b * 1e3 / (sum(ms) / len(ms))}
        print(f"[planning] serving B={b}: ms per call {', '.join(f'{x:.3f}' for x in ms)} "
              f"({serving[b]['plans_per_s']:.2f} plans/s) on {card}")
    step("serving")

    # one LM iteration: marginal ms and the device's idle share, each batch
    iter_ms, idle = {}, {}
    for b in PLAN_BATCHES:
        iter_ms[b] = lm_iter_ms(probs[b], n_small=2, extra=10, reps=2)
        pwall, busy, kernels, by_name = _profile_window(probs[b], 2)
        idle[b] = 1.0 - busy / pwall
        print(f"[planning] B={b} float32 LM iteration {iter_ms[b]:.4f} ms (marginal window); profiler, 2 "
              f"iterations: wall {pwall:.2f} ms, device busy {busy:.2f} ms (idle {100 * idle[b]:.1f} %), "
              f"{kernels / 2:.0f} device kernels an iteration, on {card}")
        for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"[planning]   {t / 2:8.3f} ms an iteration  {k // 2:5d}x  {name[:90]}")
    prob = probs[bmax]
    with torch.no_grad():
        state, aux, opts = prob.state, prob.aux, prob.opt.opts
        blocks = prob.co.linearize_blocks(state, aux)
        ns = prob.builder.build(state, aux)
        delta, _ = ns.solve(1e-3, False)
        stages = {
            "linearize": lambda: prob.co.linearize_blocks(state, aux),
            "assemble": lambda: assemble(pattern, blocks),
            "solve": lambda: ns.solve(1e-3, False),
            "retract": lambda: prob.co.retract(state, delta),
            "error": lambda: prob.co.error_metric(state, aux),
        }
        print(f"[planning] B={bmax} stages (ms, each synced, mean of 3): "
              + ", ".join(f"{k} {_synced_ms(f, reps=3):.3f}" for k, f in stages.items()) + f" on {card}")
    step("LM iteration and profile")

    # rows 2-4b (and 6-8) at d = 2, float32, at each batch
    times, bounds, library = {}, {}, {}
    for b in PLAN_BATCHES:
        _, ata, lflat, y, x, b_perm = sys_by[b]
        lv, padded = lv_by[b], padded_by[b]
        sched, pattern = probs[b].builder.sched, probs[b].builder.pattern
        fns = {
            "assemble_blocks": (lambda: assemble_blocks(pattern, padded), lambda: assemble_blocks_plain(pattern, padded)),
            "level_factor": (lambda: [level_factor(*f) for f, _, _ in lv], lambda: [level_factor_plain(*f) for f, _, _ in lv]),
            "level_fwd_subst": (lambda: [level_fwd_subst(*fw) for _, fw, _ in lv],
                                lambda: [level_fwd_subst_plain(*fw) for _, fw, _ in lv]),
            "level_bwd_subst": (lambda: [level_bwd_subst(*bw) for _, _, bw in lv],
                                lambda: [level_bwd_subst_plain(*bw) for _, _, bw in lv]),
        }
        atb = b_perm[sched.on(dev)[1]]
        bounds[b] = {
            "assemble_blocks": assembly_bound(pattern, padded),
            "level_factor": _bound(sum(_nbytes(*f) + _nbytes(f[0]) for f, _, _ in lv), factor_flops(sched, b, 2)),
            "level_fwd_subst": _bound(sum(_nbytes(*fw) + _nbytes(fw[2]) for _, fw, _ in lv),
                                      subst_flops(sched, b, 2, True)),
            "level_bwd_subst": _bound(sum(_nbytes(*bw) + _nbytes(bw[2]) for _, _, bw in lv),
                                      subst_flops(sched, b, 2, False)),
        }
        if whole_ok:
            fns.update({
                "whole_factor": (lambda: whole_factor(sched, ata), None),
                "whole_fwd_subst": (lambda: whole_fwd_subst(sched, lflat, atb), None),
                "whole_bwd_subst": (lambda: whole_bwd_subst(sched, lflat, y), None),
            })
            bounds[b].update({
                "whole_factor": _bound(_nbytes(ata, lflat), factor_flops(sched, b, 2)),
                "whole_fwd_subst": _bound(_nbytes(lflat, atb, y), subst_flops(sched, b, 2, True)),
                "whole_bwd_subst": _bound(_nbytes(lflat, y, x), subst_flops(sched, b, 2, False)),
            })
        times[b] = {}
        for k, (kern, plain) in fns.items():
            if plain is None:  # the whole kernels' twin is the per-column plan
                def plain(kern=kern):
                    with config.plain_path():
                        return kern()
            times[b][k] = (cuda_ms(kern, reps=5), cuda_ms(plain, reps=3, warmup=1), device_ms(kern, reps=5, warmup=1))
        h = dense_h(pattern, ata)
        l_dense = torch.linalg.cholesky_ex(h)[0]
        rhs = probs[b].builder.flatten(atb)[..., None]
        chol = cuda_ms(lambda: torch.linalg.cholesky_ex(h), reps=5)
        lower = cuda_ms(lambda: torch.linalg.solve_triangular(l_dense, rhs, upper=False), reps=5)
        upper = cuda_ms(lambda: torch.linalg.solve_triangular(l_dense.transpose(-1, -2), rhs, upper=True), reps=5)
        library[b] = {"level_factor": chol, "whole_factor": chol, "level_fwd_subst": lower, "whole_fwd_subst": lower,
                      "level_bwd_subst": upper, "whole_bwd_subst": upper}
        for k, (ms, plain_ms, dev_ms) in times[b].items():
            bms, by = bounds[b][k]
            lib = library[b].get(k)
            what = "one call" if k == "assemble_blocks" or k.startswith("whole") else f"one sweep, {n_levels} launches"
            print(f"[planning] {k:<16} d=2 B={b} float32 ({what}): kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms "
                  f"device, plain twin {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'} on {card}")
    step("timing")
    print(f"[planning] seconds: {json.dumps(steps)}")
    stats = {"max_abs": max_abs, "times": times, "bounds": bounds, "library": library, "lm_iter_ms": iter_ms,
             "idle": idle, "levels": n_levels, "serving": serving, "whole_launches": whole_launches,
             "samples_ms": s_ms, "covariances_ms": c_ms}
    return launches, stats


# ---------------------------------------------------------------------------
# the tactile, PCG, DCEM and GBP paths
# ---------------------------------------------------------------------------
def _counted(fn):
    """(fn(), launches during it, cholesky_ex calls during it), synced."""
    import torch

    from theseus_tpu_torch import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    with mock.patch("torch.linalg.cholesky_ex", wraps=torch.linalg.cholesky_ex) as chol:
        out = fn()
        torch.cuda.synchronize()
    return out, dict(_cuda.launches), chol.call_count


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def _grad_compare(label, g, ref, rtol, cos_min=None):
    """Norm-relative error and cosine of a flat gradient against a
    reference; held to rtol (and cos_min when given)."""
    import torch

    g, ref = g.double().cpu(), ref.double().cpu()
    rel = float((g - ref).norm() / ref.norm())
    cos = float((g * ref).sum() / (g.norm() * ref.norm()))
    held = f"(tol {rtol:.0e}" + (f", cosine min {cos_min})" if cos_min is not None else ")")
    print(f"[{label.split()[0]}] {label}: norm-rel {rel:.3e}, cosine {cos:.8f} {held}")
    check(bool(torch.isfinite(g).all()) and rel <= rtol and (cos_min is None or cos >= cos_min),
          f"{label}: gradient off (norm-rel {rel:.3e}, cosine {cos:.6f})")
    return rel, cos


def tactile_trainer(dtype, dev, inner, mode="implicit", steps=None, windows=None, batch=None, models=None):
    """(trainer, base inputs, features, obj_gt) on `dev`: the estimator at
    `steps` (TAC_STEPS) with `windows` (TAC_WINDOWS) on the sparse plan, the
    episode of synthetic_push at `batch` (TAC_BATCH), the models drawn from
    a CPU generator seeded 0 (the same weights in every dtype and on every
    device) or `models`."""
    import functools

    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.models import tactile

    steps, windows, batch = steps or TAC_STEPS, windows or TAC_WINDOWS, batch or TAC_BATCH

    est = tactile.TactilePoseEstimator(steps, *windows, max_iterations=inner, dtype=dtype, device=dev,
                                       optimizer_cls=functools.partial(tt.LevenbergMarquardt,
                                                                       linearization="sparse"))
    base, obj_gt, _, feats = tactile.synthetic_push(est, batch=batch, feature_dim=TAC_FEATURES, seed=TAC_SEED)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    trainer = tactile.TactileTrainer(est, TAC_FEATURES, generator=torch.Generator().manual_seed(0), lr=TAC_LR,
                                     backward_mode=mode, models=models, dtype=dtype, device=dev)
    return trainer, {k: t(v) for k, v in base.items()}, {i: t(v) for i, v in feats.items()}, t(obj_gt)


def _tac_grad(trainer, base, feats, obj_gt, mode, bwd_iters, plain=False):
    """(loss, flat gradient over both models, forward s, backward() s)."""
    import torch

    from theseus_tpu_torch import config

    trainer.backward_mode = mode
    params = trainer.parameters()
    with config.plain_path() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.loss(base, feats, obj_gt, bwd_iters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return float(loss), torch.cat([g.reshape(-1) for g in grads]).detach(), t1 - t0, t2 - t1


def phase_tactile(dev, card):
    """Tactile pose estimation at the Fig. 4 size: the schedule, rows 2-4b
    against their twins at its d = 3 shapes, the float32 implicit forward and
    backward() with the counters around each, ms per forward and backward()
    for every mode at both inner iteration counts, every mode's gradient
    (float64 kernels against float64 twins, float32 against float64), the
    JAX golden, three SGD steps, rows 2-4b's times."""
    import numpy as np
    import torch

    from theseus_tpu_torch.models import tactile
    from theseus_tpu_torch.sparse.assemble import assemble
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
    from theseus_tpu_torch.sparse.level_kernels import (
        level_bwd_subst, level_bwd_subst_plain, level_factor, level_factor_plain,
        level_fwd_subst, level_fwd_subst_plain)
    from theseus_tpu_torch.utils.convert import tactile_models_from_params, tactile_params_from_arrays

    steps, t_step = {}, [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 2)
        t_step[0] = now

    inner0 = TAC_INNER[0]
    tr32, base32, feats32, gt32 = tactile_trainer(torch.float32, dev, inner0)
    est = tr32.estimator
    t0 = time.perf_counter()
    bld = est.optimizer.normal_builder
    sym_s = time.perf_counter() - t0
    sched, pattern = bld.sched, bld.pattern
    n_levels = len(sched.level_tables)
    n_costs = len(est.objective.cost_functions)
    check(pattern.d == 3 and pattern.n_vars == 2 * TAC_STEPS and n_costs == 3 * TAC_STEPS - 1 + len(est.pairs),
          "tactile: not 2 T SE2 variables and 3 T - 1 + pairs costs")
    print(f"[tactile] T={TAC_STEPS}, windows {TAC_WINDOWS}: {len(est.pairs)} moving-frame pairs, {pattern.n_vars} "
          f"SE2 variables, {n_costs} costs; d={pattern.d}: {n_levels} head levels over {sched.n_head} columns, "
          f"dense tail of {sched.tail_k} columns, nnz_L {sched.sym.nnz_l} blocks; (C, rl, ul) per level "
          + " ".join(f"({len(t['cols'])},{t['row_valid'].shape[1]},{t['upd_valid'].shape[1]})"
                     for t in sched.level_tables)
          + f"; block pattern, symbolic analysis and schedule {sym_s:.3f} s on the host; the whole-sweep plan "
          f"{'takes' if sched.tail_k == 0 else 'does not take'} this schedule")
    step("objective and symbolic analysis")

    # rows 2-4b at the tactile shapes against their twins (the ground-truth measurements, weights 1)
    max_abs, systems = {}, {}
    for dn, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        tr, base, _, _ = (tr32, base32, None, None) if dtype == torch.float32 else tactile_trainer(dtype, dev, inner0)
        e = tr.estimator
        _, obj_gt, eff_gt, _ = tactile.synthetic_push(e, batch=TAC_BATCH, feature_dim=TAC_FEATURES, seed=TAC_SEED)
        meas = {k: torch.as_tensor(v, dtype=dtype, device=dev)
                for k, v in tactile.relative_measurements(e, obj_gt, eff_gt).items()}
        prob = Problem(e.objective, dict(base, **meas), iters=inner0)
        system = plain_system(prob)
        padded = padded_blocks(prob)
        lv = level_inputs(prob, *system[1:])
        cond = _plan_cond(prob.builder.pattern, system[1])
        runs = {
            "assemble_blocks": lambda cast, plain, padded=padded, pb=prob.builder.pattern: list(
                (assemble_blocks_plain if plain else assemble_blocks)(
                    pb, [([cast(j) for j in jacs], cast(err)) for jacs, err in padded])),
            **{name: (lambda cast, plain, k=k, pl=pl, idx=idx, lv=lv:
                      [(pl if plain else k)(*[cast(t) for t in ops[idx]]) for ops in lv])
               for name, k, pl, idx in (("level_factor", level_factor, level_factor_plain, 0),
                                        ("level_fwd_subst", level_fwd_subst, level_fwd_subst_plain, 1),
                                        ("level_bwd_subst", level_bwd_subst, level_bwd_subst_plain, 2))},
        }
        for name, run in runs.items():
            got = _repeatable(name, lambda run=run: run(lambda t: t, False), f"{dn} tactile B={TAC_BATCH}")
            twin = run(lambda t: t, True)
            ref = run(lambda t: t.double(), True) if dtype == torch.float32 else None
            max_abs.setdefault(name, {})[dn] = _plan_report(name, dn, got, twin, ref, cond, "tactile d=3")
        systems[dn] = (prob, system, padded, lv)
    step("kernels against twins")

    # the main path: one float32 implicit forward and its backward(), counters around each
    params = tr32.parameters()
    loss, fwd, chol_f = _counted(lambda: tr32.loss(base32, feats32, gt32))
    _, bwd, chol_b = _counted(lambda: torch.autograd.grad(loss, params))
    print(f"[tactile] float32 implicit forward ({inner0} LM iterations, B={TAC_BATCH}): loss {float(loss.detach()):.6e}, "
          f"launches {_nonzero(fwd)}, cholesky_ex {chol_f}; backward(): launches {_nonzero(bwd)}, cholesky_ex {chol_b}")
    solves = fwd["assemble_blocks"]
    check(solves >= 2 and all(fwd[k] == n_levels * solves for k in LEVEL_KERNELS) and chol_f == solves
          and fwd["tail_update"] == (solves if sched.tail_k else 0) and fwd["between_se3"] == 0,
          f"tactile forward: launches {fwd}, cholesky_ex {chol_f}")
    check(bwd["level_fwd_subst"] == n_levels and bwd["level_bwd_subst"] == n_levels and bwd["level_factor"] == 0,
          f"tactile backward(): launches {bwd}")
    launches = {k: fwd[k] + bwd[k] for k in fwd}
    step("main path forward and backward()")

    # every mode: float64 kernels against float64 twins, float32 against float64
    grads = {}
    tr64, base64, feats64, gt64 = tactile_trainer(torch.float64, dev, inner0)
    trc, basec, featsc, gtc = tactile_trainer(torch.float64, torch.device("cpu"), inner0)
    for mode, k in TAC_MODES:
        label = f"{mode}-{k}" if mode == "truncated" else mode
        l32, g32, _, _ = _tac_grad(tr32, base32, feats32, gt32, mode, k)
        l64, g64, _, _ = _tac_grad(tr64, base64, feats64, gt64, mode, k)
        if mode == "dlm":
            lref, gref, _, _ = _tac_grad(trc, basec, featsc, gtc, mode, k, plain=True)
        else:
            lref, gref, _, _ = _tac_grad(tr64, base64, feats64, gt64, mode, k, plain=True)
        print(f"[tactile] {label}: loss float32 {l32:.8e}, float64 kernels {l64:.12e}, float64 twins "
              f"({'CPU' if mode == 'dlm' else 'card'}) {lref:.12e}")
        _grad_compare(f"tactile {label} float64 kernels vs float64 twins", g64, gref, GRAD_RTOL_F64)
        grads[label] = _grad_compare(f"tactile {label} float32 vs float64", g32, g64, TAC_GRAD_RTOL_F32,
                                     TAC_GRAD_COS_F32)
    step("gradients")

    # the JAX float64 golden (T = 12, batch 4), float64 kernels on the card
    with np.load(TACTILE_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    models = tactile_models_from_params(tactile_params_from_arrays(g), dtype=torch.float64, device=dev)
    gt_t, gb = int(g["time_steps"]), int(g["batch"])
    for mode in ("unroll", "implicit"):
        trg, _, _, _ = tactile_trainer(torch.float64, dev, int(g["iters"]), mode, steps=gt_t, windows=(1, 3, 1),
                                       batch=gb, models=models)
        gbase = {k[3:]: torch.as_tensor(v, device=dev) for k, v in g.items() if k.startswith("in_")}
        gfeats = {i: torch.as_tensor(g["features"][i], device=dev) for i in range(gt_t)}
        sol = trg.solve(gbase, gfeats)
        poses = torch.stack([sol[f"obj_pose_{i}"] for i in range(gt_t)], dim=1)
        gl = torch.mean((poses[..., :2] - torch.as_tensor(g["obj_gt"], device=dev)[None, :, :2]) ** 2)
        gg = torch.autograd.grad(gl, [p for m in (trg.meas_model.mlp, trg.weight_model.mlp)
                                      for pair in zip(m.weights, m.biases) for p in pair])
        names = [f"{part}_{k}{i}" for part, n in (("meas", 3), ("weight", 2)) for i in range(n) for k in ("w", "b")]
        dpose = float((poses.detach().cpu() - torch.as_tensor(g[f"sol_{mode}"])).abs().max())
        dloss = abs(float(gl) - float(g[f"loss_{mode}"])) / abs(float(g[f"loss_{mode}"]))
        dgrad = max(float((x.cpu() - torch.as_tensor(g[f"grad_{mode}_{n}"])).abs().max())
                    / max(float(np.abs(g[f"grad_{mode}_{n}"]).max()), 1e-12) for x, n in zip(gg, names))
        print(f"[tactile] JAX golden T={gt_t} B={gb} {mode}: float64 kernels, poses max abs dev {dpose:.3e} (tol "
              f"{PLATEAU_RTOL_F64:.0e}), loss rel dev {dloss:.3e} (tol 1e-10), gradients max rel dev {dgrad:.3e} "
              f"(tol {GRAD_RTOL_F64:.0e})")
        check(dpose <= PLATEAU_RTOL_F64 and dloss <= 1e-10 and dgrad <= GRAD_RTOL_F64,
              f"tactile: off the JAX golden ({mode})")
    step("JAX golden")

    # ms per forward and backward() for every mode, float32, at each inner iteration count
    times = {}
    for inner in TAC_INNER:
        tr, base, feats, gt = (tr32, base32, feats32, gt32) if inner == inner0 else tactile_trainer(
            torch.float32, dev, inner)
        _tac_grad(tr, base, feats, gt, "implicit", 5)  # warm-up at this inner count
        for mode, k in TAC_MODES:
            label = f"{mode}-{k}" if mode == "truncated" else mode
            _, _, f_s, b_s = _tac_grad(tr, base, feats, gt, mode, k)
            times[f"{label} inner {inner}"] = (f_s * 1e3, b_s * 1e3)
            print(f"[tactile] inner {inner:>2} {label:<12} float32 B={TAC_BATCH}: forward {f_s * 1e3:9.3f} ms, "
                  f"backward() {b_s * 1e3:9.3f} ms on {card}")
    step("mode timings")

    # three implicit SGD steps of the trainer
    losses = [tr32.step(base32, feats32, gt32) for _ in range(TAC_SGD_STEPS)]
    print(f"[tactile] {TAC_SGD_STEPS} implicit SGD steps (lr {TAC_LR}), float32: losses "
          + ", ".join(f"{x:.8e}" for x in losses))
    check(all(np.isfinite(losses)), "tactile SGD: non-finite loss")
    step("SGD steps")

    # one LM iteration's ms and idle share, rows 2-4b at d = 3
    prob, system, padded, lv = systems["float32"]
    iter_ms = lm_iter_ms(prob, n_small=2, extra=5, reps=2)
    pwall, busy, kernels, by_name = _profile_window(prob, 2)
    idle = 1.0 - busy / pwall
    print(f"[tactile] float32 LM iteration {iter_ms:.4f} ms (marginal window); profiler, 2 iterations: wall "
          f"{pwall:.2f} ms, device busy {busy:.2f} ms (idle {100 * idle:.1f} %), {kernels / 2:.0f} device kernels "
          f"an iteration, on {card}")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"[tactile]   {t / 2:8.3f} ms an iteration  {k // 2:5d}x  {name[:90]}")
    with torch.no_grad():
        blocks = prob.co.linearize_blocks(prob.state, prob.aux)
        ns = prob.builder.build(prob.state, prob.aux)
        delta, _ = ns.solve(1e-3, False)
        stages = {
            "linearize": lambda: prob.co.linearize_blocks(prob.state, prob.aux),
            "assemble": lambda: assemble(pattern, blocks),
            "solve": lambda: ns.solve(1e-3, False),
            "retract": lambda: prob.co.retract(prob.state, delta),
            "error": lambda: prob.co.error_metric(prob.state, prob.aux),
        }
        print(f"[tactile] B={TAC_BATCH} stages (ms, each synced, mean of 3): "
              + ", ".join(f"{k} {_synced_ms(f, reps=3):.3f}" for k, f in stages.items()) + f" on {card}")
    _, ata, lflat, y, x, b_perm = system
    fns = {
        "assemble_blocks": (lambda: assemble_blocks(pattern, padded), lambda: assemble_blocks_plain(pattern, padded)),
        "level_factor": (lambda: [level_factor(*f) for f, _, _ in lv], lambda: [level_factor_plain(*f) for f, _, _ in lv]),
        "level_fwd_subst": (lambda: [level_fwd_subst(*fw) for _, fw, _ in lv],
                            lambda: [level_fwd_subst_plain(*fw) for _, fw, _ in lv]),
        "level_bwd_subst": (lambda: [level_bwd_subst(*bw) for _, _, bw in lv],
                            lambda: [level_bwd_subst_plain(*bw) for _, _, bw in lv]),
    }
    bounds = {
        "assemble_blocks": assembly_bound(pattern, padded),
        "level_factor": _bound(sum(_nbytes(*f) + _nbytes(f[0]) for f, _, _ in lv),
                               factor_flops(sched, TAC_BATCH, 3)),
        "level_fwd_subst": _bound(sum(_nbytes(*fw) + _nbytes(fw[2]) for _, fw, _ in lv),
                                  subst_flops(sched, TAC_BATCH, 3, True)),
        "level_bwd_subst": _bound(sum(_nbytes(*bw) + _nbytes(bw[2]) for _, _, bw in lv),
                                  subst_flops(sched, TAC_BATCH, 3, False)),
    }
    h = dense_h(pattern, ata)
    l_dense = torch.linalg.cholesky_ex(h)[0]
    rhs = prob.builder.flatten(b_perm[sched.on(dev)[1]])[..., None]
    library = {"level_factor": cuda_ms(lambda: torch.linalg.cholesky_ex(h), reps=5),
               "level_fwd_subst": cuda_ms(lambda: torch.linalg.solve_triangular(l_dense, rhs, upper=False), reps=5),
               "level_bwd_subst": cuda_ms(lambda: torch.linalg.solve_triangular(l_dense.mT, rhs, upper=True), reps=5)}
    ktimes = {}
    for k, (kern, plain) in fns.items():
        ktimes[k] = (cuda_ms(kern, reps=5), cuda_ms(plain, reps=3, warmup=1), device_ms(kern, reps=5, warmup=1))
        ms, plain_ms, dev_ms = ktimes[k]
        bms, by = bounds[k]
        lib = library.get(k)
        what = "one call" if k == "assemble_blocks" else f"one sweep, {n_levels} launches"
        print(f"[tactile] {k:<16} d=3 B={TAC_BATCH} float32 ({what}): kernel {ms:.4f} ms back to back, {dev_ms:.4f} "
              f"ms device, plain twin {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), library "
              f"{'none' if lib is None else f'{lib:.4f} ms'} on {card}")
    step("LM iteration, profile, kernel times")
    print(f"[tactile] seconds: {json.dumps(steps)}")
    return launches, {"max_abs": max_abs, "times": ktimes, "bounds": bounds, "library": library,
                      "lm_iter_ms": iter_ms, "idle": idle, "mode_ms": times, "sgd_losses": losses,
                      "grads_f32": grads}


def _pcg_grad(dtype, dev, **opt_kwargs):
    """d loss / d theta of one implicit training step at TRAIN on the given
    sparse solver."""
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.pose_graph import (
        build_pgo_objective, mean_sq_local, pose_values, synthetic_pose_graph, training_weights)

    gt, edges, meas, init = synthetic_pose_graph(*TRAIN, seed=0, dtype=dtype, device=dev)
    w_odo, w_loop = training_weights()
    obj, _ = build_pgo_objective(TRAIN[0], edges, meas, gt[0], dtype=dtype, device=dev, edge_weight=w_odo,
                                 loop_weight=w_loop)
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=ITERS, adaptive_damping=True,
                                                  linearization="sparse", **opt_kwargs))
    theta = torch.tensor(THETA0, dtype=dtype, device=dev, requires_grad=True)
    out, _ = layer.forward(dict(pose_values(init), w_loop=theta.reshape(1, 1)),
                           optimizer_kwargs={"backward_mode": "implicit"})
    (g,) = torch.autograd.grad(mean_sq_local(out, gt), theta)
    return float(g)


def phase_pcg(dev, card):
    """PGO 256 x 128 on the block-Jacobi PCG: the float32 forward with the
    counters around it (Between and assembly, no level or whole kernel),
    its plateau, ms per LM iteration beside the direct level and whole
    plans, the PCG delta against the direct delta, the implicit gradient
    against the direct solve's."""
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.optim.normal import SparseNormalBuilder

    n, b = TRAIN
    pcg32 = synthetic_problem(n, b, torch.float32, dev, sparse_solver="pcg", pcg_iters=PCG_ITERS)
    (out, info), fwd, chol = _counted(lambda: pcg32.layer.forward(pcg32.inputs))
    print(f"[pcg] PGO {n}x{b} float32 forward, {ITERS} LM iterations, {PCG_ITERS} CG iterations a solve: mean error "
          f"{float(info.err_history[0].mean()):.6e} -> {float(info.last_err.mean()):.6e}; launches {_nonzero(fwd)}")
    check(fwd["assemble_blocks"] == ITERS and fwd["between_se3"] > 0 and chol == 0
          and all(fwd[k] == 0 for k in LEVEL_KERNELS + ("whole_factor", "whole_fwd_subst", "whole_bwd_subst")),
          f"pcg forward: launches {fwd}, cholesky_ex {chol}")
    with config.plain_path():
        _, ref = synthetic_problem(n, b, torch.float64, dev).layer.forward(pcg32.inputs)
    rel = float(_rel(info.last_err, ref.last_err).max())
    print(f"[pcg] float32 PCG vs float64 direct twins: final error max rel dev {rel:.3e} (tol {PLATEAU_RTOL_F32:.0e})")
    check(rel <= PLATEAU_RTOL_F32, f"pcg: float32 plateau off by {rel:.3e}")

    level = synthetic_problem(n, b, torch.float32, dev)
    ms = {"pcg": lm_iter_ms(pcg32, n_small=2, extra=5, reps=2), "level": lm_iter_ms(level, n_small=2, extra=5, reps=2)}
    config.set_whole_sweep(True)
    try:
        ms["whole"] = lm_iter_ms(level, n_small=2, extra=5, reps=2)
    finally:
        config.set_whole_sweep(False)
    pwall, busy, kernels, _ = _profile_window(pcg32, 2)
    idle = 1.0 - busy / pwall
    print(f"[pcg] float32 LM iteration: PCG {ms['pcg']:.4f} ms, direct level plan {ms['level']:.4f} ms, whole "
          f"plan {ms['whole']:.4f} ms (marginal windows); PCG: {fwd['between_se3'] / ITERS:.2f} Between and "
          f"{fwd['assemble_blocks'] / ITERS:.0f} assembly launches an iteration, {kernels / 2:.0f} device kernels "
          f"an iteration, idle {100 * idle:.1f} %, on {card}")

    # float64: the PCG delta against the direct delta on one normal system
    p64 = synthetic_problem(n, b, torch.float64, dev)
    ns_d = p64.builder.build(p64.state, p64.aux)
    for iters in (PCG_ITERS, PCG_CHECK_ITERS):
        ns_p = SparseNormalBuilder(p64.co, solver="pcg", pcg_iters=iters).build(p64.state, p64.aux)
        for damping in (0.0, 1e-3, PCG_CHECK_DAMPING):
            dd, _ = ns_d.solve(damping, False)
            dp, _ = ns_p.solve(damping, False)
            viol = float(((dp - dd).abs() - (1e-8 + 1e-6 * dd.abs())).max())
            relv = float((dp - dd).norm() / dd.norm())
            held = iters == PCG_CHECK_ITERS and damping == PCG_CHECK_DAMPING
            print(f"[pcg] float64 delta, {iters} CG iterations, damping {damping:g}: norm-rel {relv:.3e} from the "
                  f"direct delta, worst excess over rtol 1e-6 + atol 1e-8 {viol:.3e}" + (" (held)" if held else ""))
            if held:
                check(viol <= 0.0, f"pcg: delta off the direct delta by {viol:.3e} beyond its tolerance")
    g_direct = _pcg_grad(torch.float64, dev)
    g_pcg = _pcg_grad(torch.float64, dev, sparse_solver="pcg", pcg_iters=PCG_GRAD_ITERS)
    g_default = _pcg_grad(torch.float64, dev, sparse_solver="pcg", pcg_iters=PCG_ITERS)
    rel_g = abs(g_pcg - g_direct) / abs(g_direct)
    print(f"[pcg] float64 implicit gradient d loss / d theta: direct {g_direct:.10e}, PCG {PCG_GRAD_ITERS} "
          f"iterations {g_pcg:.10e} (rel dev {rel_g:.3e}, tol 1e-3), PCG {PCG_ITERS} iterations {g_default:.10e} "
          f"(rel dev {abs(g_default - g_direct) / abs(g_direct):.3e}, printed)")
    check(rel_g <= 1e-3, f"pcg: implicit gradient off the direct solve's by {rel_g:.3e}")
    return fwd, {"lm_iter_ms": ms, "idle": idle}


def phase_dcem(dev, card):
    """DCEM on the 7-dof IK: ms per iteration and the pose residuals at
    batch DCEM_BATCH; float64 on the card against the CPU fed the same
    noise; one unroll gradient with respect to the targets, the same way."""
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.inverse_kinematics import build_ik_layer, ik_targets

    def dcem(dtype, device, iters, generator=None):
        layer, fk, robot = build_ik_layer(dtype, device)
        return tt.DCEM(layer.objective, max_iterations=iters, generator=generator), fk, robot

    opt, fk, robot = dcem(torch.float32, dev, DCEM_ITERS)
    targets = ik_targets(fk, robot.dof, DCEM_BATCH, torch.float32, dev)
    inputs = {"theta": torch.zeros((DCEM_BATCH, robot.dof), device=dev), "target": targets}
    gen = torch.Generator(device=dev).manual_seed(DCEM_SEED)
    opt.optimize(input_tensors=inputs, generator=gen, max_iterations=2)  # warm-up
    t0 = time.perf_counter()
    (out, info), fwd, _ = _counted(lambda: opt.optimize(input_tensors=inputs, generator=gen))
    wall = time.perf_counter() - t0
    res = ik_residual_norm(fk, out["theta"], targets)
    print(f"[dcem] IK B={DCEM_BATCH}, {opt.opts.n_sample} samples, {opt.opts.n_elite} elites, {DCEM_ITERS} "
          f"iterations, float32: {wall * 1e3 / DCEM_ITERS:.3f} ms an iteration ({DCEM_BATCH * opt.opts.n_sample} "
          f"FK evaluations each), pose residual median {float(res.median()):.4e}, worst {float(res.max()):.4e}; "
          f"mean error {float(info.err_history[0].mean()):.4e} -> {float(info.last_err.mean()):.4e}; launches "
          f"{_nonzero(fwd) or 'none (no kernel of the table on this path)'}, on {card}")
    check(bool(torch.isfinite(out["theta"]).all()) and float(info.last_err.mean()) < float(info.err_history[0].mean()),
          "dcem: the solve did not descend")

    # float64: the card against the CPU on the same targets and noise (a CPU generator)
    cpu = torch.device("cpu")
    _, fk_cpu, _ = dcem(torch.float64, cpu, 1)
    b, iters = DCEM_CHECK
    sols = {}
    for key, where in (("card", dev), ("cpu", cpu)):
        o, _, _ = dcem(torch.float64, where, iters, torch.Generator().manual_seed(DCEM_SEED))
        tg = ik_targets(fk_cpu, robot.dof, b, torch.float64, cpu)
        sols[key], _ = o.optimize(input_tensors={
            "theta": torch.zeros((b, robot.dof), dtype=torch.float64, device=where), "target": tg.to(where)})
    dev_f64 = float((sols["card"]["theta"].cpu() - sols["cpu"]["theta"]).abs().max())
    print(f"[dcem] float64 B={b}, {iters} iterations, card vs CPU on the same targets and noise: joint angles max "
          f"abs dev {dev_f64:.3e} (tol {DCEM_F64_TOL:.0e})")
    check(dev_f64 <= DCEM_F64_TOL, f"dcem: card off the CPU by {dev_f64:.3e}")
    b, iters = DCEM_GRAD
    grads = {}
    for key, where in (("card", dev), ("cpu", cpu)):
        o, _, _ = dcem(torch.float64, where, iters, torch.Generator().manual_seed(DCEM_SEED))
        tg = ik_targets(fk_cpu, robot.dof, b, torch.float64, cpu).to(where)
        tg.requires_grad_(True)
        out64, _ = tt.TheseusLayer(o).forward({"theta": torch.zeros((b, robot.dof), dtype=torch.float64,
                                                                     device=where), "target": tg})
        grads[key] = torch.autograd.grad(torch.sum(out64["theta"] ** 2), tg)[0].reshape(-1)
    _grad_compare(f"dcem unroll gradient d sum(theta^2) / d targets, B={b}, {iters} iterations, float64 card vs CPU",
                  grads["card"], grads["cpu"], GRAD_RTOL_F64)
    return fwd, {"ms_per_iter": wall * 1e3 / DCEM_ITERS, "residual_median": float(res.median()),
                 "residual_worst": float(res.max())}


def phase_gbp(dev, card):
    """Gaussian belief propagation on PGO 256 x 128: the float32 forward with
    the counters around it (the Between kernel, no assembly or level
    kernel), ms per sweep and per outer iteration, the final error beside
    LM's; float64 kernels against twins; compute_covariances on a tree
    against the sparse path's."""
    import torch

    import theseus_tpu_torch as tt
    from theseus_tpu_torch import config

    n, b = TRAIN
    kw = dict(max_iterations=GBP_OUTER, msg_iters=GBP_MSG_ITERS, msg_damping=GBP_DAMPING)

    def gbp_problem(dtype, **extra):
        prob = synthetic_problem(n, b, dtype, dev)
        prob.layer = tt.TheseusLayer(tt.GaussianBeliefPropagation(prob.obj, **kw, **extra))
        prob.opt = prob.layer.optimizer
        prob.builder = prob.opt.normal_builder
        return prob

    g32 = gbp_problem(torch.float32)
    (out, info), fwd, chol = _counted(lambda: g32.layer.forward(g32.inputs))
    lm = synthetic_problem(n, b, torch.float32, dev, iters=GBP_OUTER)
    _, lm_info = lm.layer.forward(lm.inputs)
    print(f"[gbp] PGO {n}x{b} float32, {GBP_OUTER} outer iterations of {GBP_MSG_ITERS} sweeps (message damping "
          f"{GBP_DAMPING}): mean error {float(info.err_history[0].mean()):.6e} -> {float(info.last_err.mean()):.6e} "
          f"(LM on the same graph, {GBP_OUTER} iterations: {float(lm_info.last_err.mean()):.6e}); launches "
          f"{_nonzero(fwd)}")
    check(bool(torch.isfinite(info.last_err).all()) and fwd["between_se3"] > 0 and fwd["assemble_blocks"] == 0 and chol == 0
          and all(fwd[k] == 0 for k in LEVEL_KERNELS), f"gbp forward: launches {fwd}")
    check(float(info.last_err.mean()) < float(info.err_history[0].mean()), "gbp: the solve did not descend")

    with torch.no_grad():
        ns = g32.builder.build(g32.state, g32.aux)
        prior_lam, prior_eta = ns._priors(0.0, None)
        msgs = tuple(tuple((torch.zeros_like(e), torch.zeros_like(lam_b[s][0])) for s, e in enumerate(eta_b))
                     for eta_b, lam_b in zip(ns.etas, ns.lams))
        sweep_ms = _synced_ms(lambda: ns._sweep(msgs, prior_lam, prior_eta, GBP_DAMPING), reps=5)
    iter_ms = lm_iter_ms(g32, n_small=1, extra=2, reps=2)
    pwall, busy, kernels, _ = _profile_window(g32, 1)
    idle = 1.0 - busy / pwall
    print(f"[gbp] float32: one sweep {sweep_ms:.3f} ms (synced), one outer iteration {iter_ms:.3f} ms (marginal "
          f"window); profiler, 1 outer iteration: {kernels:.0f} device kernels, idle {100 * idle:.1f} %, on {card}")

    g64 = gbp_problem(torch.float64)
    _, i64 = g64.layer.forward(g64.inputs)
    with config.plain_path():
        _, i64p = g64.layer.forward(g64.inputs)
    rel = float(_rel(i64.last_err, i64p.last_err).max())
    print(f"[gbp] float64 kernels vs float64 twins: final error max rel dev {rel:.3e} (tol 1e-10)")
    check(rel <= 1e-10, f"gbp: float64 kernels off the twins by {rel:.3e}")

    tn, tb = GBP_TREE
    tree = synthetic_problem(tn, tb, torch.float64, dev, extra_loop_closures=False)
    sol, _ = tree.layer.forward(tree.inputs)
    names = [f"pose_{i}" for i in range(0, tn, 8)]
    want = tree.layer.compute_covariances(values=sol, var_names=names)
    gbp_tree = tt.TheseusLayer(tt.GaussianBeliefPropagation(tree.obj, msg_iters=GBP_TREE_SWEEPS, msg_damping=0.0,
                                                            gbp_ridge=0.0))
    (got, ms), cfwd, _ = _counted(lambda: once_ms(lambda: gbp_tree.compute_covariances(values=sol, var_names=names)))
    worst = max(float((got[k] - want[k]).abs().max()) / float(want[k].abs().max()) for k in names)
    print(f"[gbp] compute_covariances of {len(names)} poses on the {tn}x{tb} chain (a tree), float64, "
          f"{GBP_TREE_SWEEPS} sweeps: {ms:.3f} ms, launches {_nonzero(cfwd)}; against the sparse path's max rel "
          f"dev {worst:.3e} (tol {PLATEAU_RTOL_F64:.0e}), no ridge")
    check(worst <= PLATEAU_RTOL_F64, f"gbp: tree covariances off the sparse path's by {worst:.3e}")
    return fwd, {"sweep_ms": sweep_ms, "outer_iter_ms": iter_ms, "idle": idle,
                 "final_err": float(info.last_err.mean()), "lm_final_err": float(lm_info.last_err.mean())}


# ---------------------------------------------------------------------------
# the homography path: learned-feature training and the dense photometric fit
# ---------------------------------------------------------------------------
def _homog_step(trainer, pairs):
    """One Adam step with its forward (the loss) and backward() timed
    apart, each ended by a sync: (loss, forward ms, backward ms)."""
    import torch

    trainer.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.loss(*pairs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trainer.optimizer.step()
    return float(loss.detach()), (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _grads(module):
    import torch

    return torch.cat([p.grad.reshape(-1) for p in module.parameters()])


def phase_homography(dev, card):
    """The learned-feature homography task (HomographyTrainer, truncated
    backward through TheseusLayer) trained at batch HOMOG_BATCH in float32
    on the card, with the counters reset just before and read just after
    (no kernel of the table lies on this path: the dense linearization is
    one scatter, a batched matmul, cholesky_ex and two solve_triangular,
    the CNN is conv2d); per step the forward and backward() ms and the
    losses; one profiled step's idle share; stride 1 and the fwd/rev
    ablation; the float32 step-0 gradient against float64's; then the
    dense photometric fit at 60 x 80."""
    import torch

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.utils.examples import homography as hg
    from theseus_tpu_torch.utils.examples.easyaug import warp_images

    h, w = HOMOG_HW
    gen = torch.Generator(device=dev).manual_seed(HOMOG_SEED)

    def pairs(batch=HOMOG_BATCH, dtype=torch.float32):
        return hg.make_pairs(batch, h, w, generator=gen, dtype=dtype, device=dev)

    def trainer(stride=HOMOG_STRIDE, mode="fwd", dtype=torch.float32, cnn_state=None):
        tr = hg.HomographyTrainer(h, w, HOMOG_CHANNELS, stride, mode, HOMOG_ITERS, HOMOG_BWD, HOMOG_LR, dtype,
                                  dev, generator=torch.Generator(device=dev).manual_seed(HOMOG_SEED + 1))
        if cnn_state is not None:
            tr.cnn.load_state_dict({k: v.to(dtype) for k, v in cnn_state.items()})
        return tr

    tr = trainer()
    init_state = {k: v.clone() for k, v in tr.cnn.state_dict().items()}
    n_pts = tr.patch.shape[0]
    print(f"[homography] learned features: {h}x{w} images, {HOMOG_CHANNELS} channels, patch stride {HOMOG_STRIDE} "
          f"({n_pts} points, {n_pts * HOMOG_CHANNELS} residual rows), {HOMOG_ITERS} LM iterations, truncated "
          f"backward over {HOMOG_BWD}, Adam {HOMOG_LR}, batch {HOMOG_BATCH}, float32, on {card}")
    data = [pairs() for _ in range(HOMOG_STEPS)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses, fwd_ms, bwd_ms = [], [], []
    grad0 = None
    for i, batch in enumerate(data):
        loss, f_ms, b_ms = _homog_step(tr, batch)
        if i == 0:
            grad0 = _grads(tr.cnn).detach().clone()
        losses.append(loss)
        fwd_ms.append(f_ms)
        bwd_ms.append(b_ms)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    print(f"[homography] launches of the table's kernels over the {HOMOG_STEPS} steps: {json.dumps(launches)} "
          f"(none expected: no kernel of the table lies on this path)")
    check(not any(launches.values()), "homography: a kernel of the table ran on a path that has none")
    print(f"[homography] losses (mean corner error, px): {json.dumps([round(x, 6) for x in losses])}")
    print(f"[homography] forward ms a step: {json.dumps([round(x, 3) for x in fwd_ms])}")
    print(f"[homography] backward() ms a step: {json.dumps([round(x, 3) for x in bwd_ms])}")
    steady_f = sorted(fwd_ms[1:])[len(fwd_ms[1:]) // 2]
    steady_b = sorted(bwd_ms[1:])[len(bwd_ms[1:]) // 2]
    step_pairs = pairs()
    torch.cuda.synchronize()
    wall, busy, by_name = _device_window(lambda: tr.step(*step_pairs))
    busy, n_events = sum(busy.values()), sum(k for _, k in by_name.values())
    idle = 1 - busy / wall
    print(f"[homography] steps 2..{HOMOG_STEPS} median: forward {steady_f:.3f} ms, backward() {steady_b:.3f} ms; "
          f"first step {fwd_ms[0]:.3f} + {bwd_ms[0]:.3f} ms; one profiled step: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms (idle {100 * idle:.1f} %), {n_events} device kernels; on {card}")
    check(all(math.isfinite(x) for x in losses), "homography: a non-finite loss")
    check(min(losses) < losses[0], f"homography: training did not reduce the corner error ({losses[0]} first)")

    variants = {}
    for label, stride, mode in (("stride1", 1, "fwd"), ("fwd", HOMOG_STRIDE, "fwd"), ("rev", HOMOG_STRIDE, "rev")):
        tv = trainer(stride, mode, cnn_state=init_state)
        rows = [_homog_step(tv, batch) for batch in data[:HOMOG_EXTRA]]
        variants[label] = {"losses": [r[0] for r in rows], "forward_ms": [r[1] for r in rows],
                           "backward_ms": [r[2] for r in rows]}
        np_v = tv.patch.shape[0]
        print(f"[homography] {label}: patch stride {stride} ({np_v} points, {np_v * HOMOG_CHANNELS} rows), "
              f"autograd_mode {mode}: forward ms {json.dumps([round(r[1], 3) for r in rows])}, backward() ms "
              f"{json.dumps([round(r[2], 3) for r in rows])}, losses {json.dumps([round(r[0], 6) for r in rows])}; "
              f"on {card}")
        check(all(math.isfinite(r[0]) for r in rows), f"homography {label}: a non-finite loss")

    # the float32 gradient at step 0 against the float64 gradient of the same
    # step: as trained (reported), and with fixed damping and no stopping
    # tests (held). With adaptive damping an LM step's accept or reject, and
    # with the tests an element's stop, is decided by error comparisons at
    # the rounding level, so the two precisions can truncate the backward
    # through different iterations: a different function, not a rounding
    # error of the same one.
    import dataclasses

    def step0_grad(dtype, **opts):
        t = trainer(dtype=dtype, cnn_state=init_state)
        t.layer.optimizer.opts = dataclasses.replace(t.layer.optimizer.opts, **opts)
        t.loss(*(x.to(dtype) for x in data[0])).backward()
        return _grads(t.cnn).double()

    grad_cmp = {}
    for label, g32, opts in (
            ("as trained", grad0.double(), {}),
            ("fixed damping, no stopping tests", None,
             {"adaptive_damping": False, "abs_err_tolerance": 0.0, "rel_err_tolerance": 0.0})):
        if g32 is None:
            g32 = step0_grad(torch.float32, **opts)
        g64 = step0_grad(torch.float64, **opts)
        rel = float((g32 - g64).norm() / g64.norm())
        cos = float(torch.dot(g32, g64) / (g32.norm() * g64.norm()))
        grad_cmp[label] = {"rel": rel, "cos": cos}
        held = "held" if opts else "reported, not held"
        print(f"[homography] step-0 CNN gradient ({label}), float32 against float64 on the card: norm-relative "
              f"error {rel:.3e}, cosine {cos:.8f} ({held}" + (f": tol {HOMOG_GRAD_RTOL:.0e}, min cosine "
                                                            f"{HOMOG_GRAD_COS})" if opts else ")"))
    fixed = grad_cmp["fixed damping, no stopping tests"]
    check(fixed["rel"] <= HOMOG_GRAD_RTOL and fixed["cos"] >= HOMOG_GRAD_COS,
          "homography: float32 gradient off the float64 one")

    # the dense photometric fit at 60 x 80
    fh, fw = FIT_HW
    fit = {}
    h_true = torch.tensor(FIT_H_TRUE, dtype=torch.float64, device=dev)
    for b in FIT_BATCHES:
        img1 = hg.smooth_images(b, fh, fw, generator=gen, dtype=torch.float64, device=dev)
        if b == 1:
            h8s = h_true[None]
        else:
            geo, _ = hg.pair_augmenters()
            h8s = geo.transforms(geo.draw(b, gen, torch.float64, dev), fh, fw)
        img2 = warp_images(img1, h8s)
        est = {}
        for dtype in (torch.float32, torch.float64):
            est[dtype], info = hg.fit_photometric(img1.to(dtype), img2.to(dtype), FIT_ITERS)
            check(bool(torch.isfinite(est[dtype]).all()), f"fit batch {b}: non-finite estimate")
        ce = {str(dt)[6:]: float(hg.corner_error(e.double(), h8s, fh, fw)) for dt, e in est.items()}
        ms = {}
        for dtype in (torch.float32, torch.float64):
            layer, inputs = hg.build_photometric(img1.to(dtype), img2.to(dtype), FIT_ITERS)
            kw = {"abs_err_tolerance": 0.0, "rel_err_tolerance": 0.0}

            def run(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    layer.forward(inputs, optimizer_kwargs={"max_iterations": n, **kw})
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            n0, k = FIT_WINDOW
            run(n0)
            t_small = min(run(n0) for _ in range(3))
            t_large = min(run(n0 + k) for _ in range(3))
            ms[str(dtype)[6:]] = (t_large - t_small) / k * 1e3
        fit[b] = {"corner_error_px": ce, "lm_iter_ms": ms}
        dev_entry = float((est[torch.float32].double() - h8s).abs().max())
        print(f"[homography] dense photometric fit {fh}x{fw}, batch {b}, {FIT_ITERS} LM iterations from identity: "
              f"corner error (px) {json.dumps(ce)}, float32 estimate max entrywise deviation from the truth "
              f"{dev_entry:.3e}; ms per LM iteration (t({n0 + k}) - t({n0})) / {k}: {json.dumps(ms)}; on {card}")
        if b == 1:
            check(dev_entry < FIT_ASSERT, f"fit: the float32 estimate is {dev_entry:.3e} off h_true")
        else:
            check(abs(ce["float32"] - ce["float64"]) <= FIT_CORNER_TOL,
                  f"fit batch {b}: float32 corner error {ce['float32']:.4f} vs float64 {ce['float64']:.4f} px")
    return {"losses": losses, "forward_ms": fwd_ms, "backward_ms": bwd_ms, "steady_forward_ms": steady_f,
            "steady_backward_ms": steady_b, "idle": idle, "variants": variants, "grad": grad_cmp, "fit": fit}


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the sharded paths: batch sharding (PGO) and GBP factor sharding
# ---------------------------------------------------------------------------
def _mesh_devices(dev):
    """(label, devices) of every mesh the sharded phases run: two shards on
    one card always, and one shard per card when there are more."""
    import torch

    meshes = [("2x" + str(dev), [dev, dev])]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards",
                       [torch.device("cuda", i) for i in range(torch.cuda.device_count())]))
    return meshes


@contextlib.contextmanager
def _per_shard_launches(layer, out):
    """Append each shard's launch counts (its solve_state call, synced) to `out`."""
    import torch

    from theseus_tpu_torch import _cuda

    orig = layer.solve_state

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        before = dict(_cuda.launches)
        carry = orig(*args, **kwargs)
        torch.cuda.synchronize()
        out.append({k: _cuda.launches[k] - before[k] for k in before})
        return carry

    layer.solve_state = counted
    try:
        yield
    finally:
        del layer.solve_state


def _sharded_forward(prob, mesh, mode="unroll"):
    """The sharded solve of prob's packed state and aux (no gradient):
    (carry joined on mesh.home, per-shard launches)."""
    import torch

    from theseus_tpu_torch.parallel import shard_map_solve, shard_problem

    shards = []
    with torch.no_grad(), _per_shard_launches(prob.layer, shards):
        carry = shard_map_solve(prob.layer, mesh, mode)(*shard_problem(prob.co, prob.state, prob.aux, mesh))
    return carry, shards


def _unsharded_forward(prob, mode="unroll"):
    import torch

    with torch.no_grad():
        return _counted(lambda: prob.layer.solve_state(prob.state, prob.aux, mode, prob.opt.opts))[:2]


def _lm_solve(prob):
    """solve(n, scale) for `marginal_ms` and `_idle_share`: n fixed LM
    iterations (`run_scan`) from prob's state scaled by `scale`, no
    gradient; returns the final error."""
    import torch

    opt, opts = prob.opt, prob.opt.opts

    def solve(n, scale):
        state = {k: v * scale for k, v in prob.state.items()}
        with torch.no_grad():
            return opt.run_scan(opt.init_carry(state, prob.aux, opts), prob.aux, n, opts)["err"]

    return solve


def _sharded_solve(prob, mesh):
    """`_lm_solve` over the shards, through the entry the sharded forward
    uses: shard_problem, then shard_map_solve in "unroll" mode with
    max_iterations n (init_carry and n fixed iterations a shard, each under
    its device) and the join; returns the joined final error."""
    import dataclasses

    import torch

    from theseus_tpu_torch.parallel import shard_map_solve, shard_problem

    def solve(n, scale):
        state = {k: v * scale for k, v in prob.state.items()}
        opts = dataclasses.replace(prob.opt.opts, max_iterations=n)
        with torch.no_grad():
            run = shard_map_solve(prob.layer, mesh, "unroll", opts)
            return run(*shard_problem(prob.co, state, prob.aux, mesh))["err"]

    return solve


def _idle_share(solve, devices, n=SHARD_PROFILE_ITERS):
    """1 - device busy / (cards x wall) of solve(n, 1.0) (`_device_window`)
    over the distinct cards in `devices`, after one warm call."""
    import torch

    solve(n, 1.0)
    wall, busy, _ = _device_window(lambda: solve(n, 1.0))
    cards = {torch.device(d).index or 0 for d in devices}
    return 1.0 - sum(busy.get(i, 0.0) for i in cards) / (len(cards) * wall)


# kernel launches a path makes, held against the plain twins on their own
# inputs: the first launch of each distinct input shape, up to RECORD_CAP a
# kernel and a path
RECORD_CAP = 64


def _solver_entries():
    """{counter name: (module, attribute)}: where the solver looks up each
    kernel's wrapper at call time. Under config.plain_path() each wrapper
    runs its plain twin."""
    from theseus_tpu_torch.ops import between_se3, reprojection
    from theseus_tpu_torch.sparse import assemble, cholesky, whole

    return {"between_se3": (between_se3, "between_linearize"),
            "reprojection": (reprojection, "reprojection_linearize"),
            "assemble_blocks": (assemble, "assemble_blocks"),
            "level_factor": (cholesky, "level_factor"),
            "level_fwd_subst": (cholesky, "level_fwd_subst"),
            "level_bwd_subst": (cholesky, "level_bwd_subst"),
            "whole_factor": (cholesky, "whole_factor"),
            "whole_fwd_subst": (whole, "whole_fwd_subst"),
            "whole_bwd_subst": (whole, "whole_bwd_subst")}


def _tensors(x):
    """The tensors of a (list | tuple)-of-tensors tree, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _detached(x):
    """A detached copy of the tensors of a (list | tuple) tree; other leaves
    (a pattern, a schedule) as they are."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_detached(v) for v in x)
    return x


@contextlib.contextmanager
def _recording(records):
    """Inside the block, keep in `records` ({name: [(args, outputs)]}) the
    inputs and outputs of kernel launches (`_solver_entries`); a wrapper
    call that ran its twin is not kept."""
    from theseus_tpu_torch import _cuda

    def wrap(name, orig):
        seen = set()

        def rec(*args):
            key = tuple((tuple(t.shape), t.dtype) for t in _tensors(args))
            keep = key not in seen and len(records.get(name, ())) < RECORD_CAP
            saved = _detached(args) if keep else None
            before = _cuda.launches[name]
            out = orig(*args)
            if keep and _cuda.launches[name] > before:
                seen.add(key)
                records.setdefault(name, []).append((saved, _detached(out)))
            return out

        return rec

    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in _solver_entries().items():
            stack.enter_context(mock.patch.object(mod, attr, wrap(name, getattr(mod, attr))))
        yield records


def _hold_recorded(label, records, launched):
    """Every kept launch against its wrapper's plain twin on the same inputs,
    at KERNEL_TOL; one line a kernel and dtype. Fails when a kernel in
    `launched` (the path's launch counts) has no launch kept."""
    from theseus_tpu_torch import config

    entries = _solver_entries()
    missing = [k for k, v in launched.items() if v and k in entries and k not in records]
    check(not missing, f"{label}: no launch of {missing} was kept to hold against its twin")
    for name, calls in records.items():
        mod, attr = entries[name]
        worst = {}
        for args, out in calls:
            with config.plain_path():
                twin = getattr(mod, attr)(*args)
            dn = str(_tensors(out)[0].dtype).split(".")[-1]
            a, r = _twin_dev(name, dn, _tensors(out), _tensors(twin))
            wa, wr, k = worst.get(dn, (0.0, 0.0, 0))
            worst[dn] = (max(wa, a), max(wr, r), k + 1)
        for dn, (wa, wr, k) in worst.items():
            tol = KERNEL_TOL[dn].get(name, KERNEL_TOL[dn]["default"])
            print(f"[{label.split()[0]}] {label}: {name} {dn}, {k} launches (one a distinct input shape) against "
                  f"the twin on their inputs: max_abs={wa:.3e} max_rel(to max(1,|twin|))={wr:.3e} tol={tol:.0e} "
                  f"{'ok' if wr <= tol else 'FAIL'}")
            check(wr <= tol, f"{label}: {name} {dn} deviates from its twin by {wr:.3e} > {tol}")


def _sharded_train_step(layer, poses, gt, theta, mesh, mode="implicit"):
    """train_step through shard_problem and shard_map_solve: (loss, per-shard
    launches of the forward)."""
    from theseus_tpu_torch.parallel import shard_map_solve, shard_problem
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

    theta.grad = None
    co = layer.objective.compile()
    values = layer.objective.default_values(dict(poses, w_loop=theta.reshape(1, 1)))
    bsz = co.resolve_batch_size(values)
    shards = []
    with _per_shard_launches(layer, shards):
        carry = shard_map_solve(layer, mesh, mode)(*shard_problem(co, co.pack(values, bsz),
                                                                  co.build_aux(values, bsz), mesh))
    out = dict(values)
    out.update(co.unpack(carry["state"]))
    loss = mean_sq_local(out, gt)
    loss.backward()
    return loss.detach(), shards


def _train_pair(dtype, dev, mesh, shape=TRAIN, mode="implicit", iters=ITERS, steps=1, ref_mesh=None):
    """(losses, grads) of `steps` SGD steps, the reference (unsharded, or
    sharded over ref_mesh) then sharded over mesh, each from THETA0 with the
    learning rate set by its own first gradient."""
    import torch

    out = {}
    for sharded in (False, True):
        layer, poses, gt = train_problem(*shape, dtype, dev, iters=iters)
        theta = torch.tensor(THETA0, dtype=dtype, device=dev, requires_grad=True)
        losses, grads, sgd, shard_launches = [], [], None, []
        for _ in range(steps):
            if sharded or ref_mesh is not None:
                loss, shards = _sharded_train_step(layer, poses, gt, theta, mesh if sharded else ref_mesh, mode)
                shard_launches.append(shards)
            else:
                loss, _, _, _ = train_step(layer, poses, gt, theta, mode)
            g = theta.grad.detach().clone()
            if sgd is None:
                sgd = torch.optim.SGD([theta], lr=SGD_FIRST_STEP / max(abs(float(g)), 1e-30))
            sgd.step()
            losses.append(float(loss))
            grads.append(float(g))
        out[sharded] = (losses, grads, shard_launches)
    return out


def phase_sharded(dev, card):
    """Batch sharding: PGO SHARD_PGO on make_mesh(devices=[card, card]) (and
    one shard per card when there are more), level and whole-sweep plans;
    the float32 forward with each shard's launches, the solution against
    the unsharded solve (float32, float64), three float32 implicit training
    steps and one float64 step sharded against unsharded, an unrolled
    float64 step at UNROLL, and the LM iteration's ms and idle share
    sharded and unsharded. One shard per card: float32 is held bit for bit
    against the same shards on one card and by the plateau rule against the
    unsharded solve; float64 against the unsharded solve."""
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.parallel import make_mesh

    n, b = SHARD_PGO
    launches = {k: 0 for k in KERNEL_INFO}
    report = {"mesh": {}, "lm_iter_ms": {}, "idle": {}}
    for label, devices in _mesh_devices(dev):
        mesh = make_mesh(devices=devices)
        shard_b = b // len(mesh)
        for whole in (False, True):
            plan = "whole" if whole else "level"
            config.set_whole_sweep(whole)
            try:
                for dtype, tol in ((torch.float32, SHARD_TOL_F32), (torch.float64, SHARD_TOL_F64)):
                    dn = str(dtype).split(".")[-1]
                    prob = synthetic_problem(n, b, dtype, dev)
                    ref, ref_launches = _unsharded_forward(prob)
                    records = {}
                    with _recording(records):
                        (carry, shards), fwd, _ = _counted(lambda: _sharded_forward(prob, mesh))
                    _hold_recorded(f"sharded {dn} {plan} on {label}", records, fwd)
                    dev_max = float((carry["state"]["SE3"] - ref["state"]["SE3"]).abs().max())
                    print(f"[sharded] {n}x{b} {dn} {plan} plan on {label} ({len(mesh)} shards of {shard_b}), "
                          f"{ITERS} LM iterations: max |sharded - unsharded| {dev_max:.3e} (tol {tol:.0e}); "
                          f"per-shard launches {[_nonzero(s) for s in shards]}, unsharded {_nonzero(ref_launches)}")
                    check(bool(torch.isfinite(carry["err"]).all()), f"sharded {dn} {plan}: non-finite error")
                    if label.startswith("2x") or dtype == torch.float64:
                        check(dev_max <= tol, f"sharded {dn} {plan}: off the unsharded solve by {dev_max:.3e}")
                    else:
                        one_card, _ = _sharded_forward(prob, make_mesh(devices=[dev] * len(mesh)))
                        same = float((carry["state"]["SE3"] - one_card["state"]["SE3"]).abs().max())
                        plateau = float(_rel(carry["err"], ref["err"]).max())
                        print(f"[sharded] {dn} {plan} on {label}: against {len(mesh)} shards of {shard_b} on one card "
                              f"max |dev| {same:.3e} (tol {tol:.0e}); final error against the unsharded max rel dev "
                              f"{plateau:.3e} (tol {PLATEAU_RTOL_F32:.0e}: shards of {shard_b} round otherwise)")
                        check(same <= tol, f"sharded {dn} {plan}: one shard per card differs from one card")
                        check(plateau <= PLATEAU_RTOL_F32, f"sharded {dn} {plan}: off the unsharded plateau")
                    check(carry["state"]["SE3"].device == mesh.home and carry["state"]["SE3"].shape[1] == b,
                          "sharded: the joined carry is not the whole batch on the home device")
                    for s in shards:
                        check(s == ref_launches, f"sharded {plan}: a shard's launches {_nonzero(s)} differ from "
                                                 f"the unsharded schedule's {_nonzero(ref_launches)}")
                    if dtype == torch.float32 and label.startswith("2x"):
                        for k, v in fwd.items():
                            launches[k] += v
                        report["mesh"][plan] = {"max_dev_f32": dev_max, "shard_launches": _nonzero(shards[0])}
                    elif dtype == torch.float64:
                        report["mesh"].setdefault(plan, {})["max_dev_f64"] = dev_max
                    if dtype == torch.float32:
                        # the LM iteration, unsharded and over the shards, in the same call
                        # in the order unsharded, sharded, sharded, unsharded: the host drifts
                        un, sh = _lm_solve(prob), _sharded_solve(prob, mesh)
                        t_un1, t_sh1, t_sh2, t_un2 = (marginal_ms(f) for f in (un, sh, sh, un))
                        t_un, t_sh = (t_un1 + t_un2) / 2, (t_sh1 + t_sh2) / 2
                        idle_un, idle_sh = _idle_share(un, [dev]), _idle_share(sh, mesh.devices)
                        key = plan if label.startswith("2x") else f"{plan} {label}"
                        report["lm_iter_ms"][key] = {"unsharded": [t_un1, t_un2], "sharded": [t_sh1, t_sh2],
                                                     "ratio": t_sh / t_un}
                        report["idle"][key] = {"unsharded": idle_un, "sharded": idle_sh}
                        print(f"[sharded] LM iteration, {plan} plan, float32 {n}x{b} on {label}: unsharded {t_un1:.3f}, "
                              f"{t_un2:.3f} ms (idle {100 * idle_un:.1f} %), {len(mesh)} shards of {shard_b} in turn "
                              f"through shard_map_solve {t_sh1:.3f}, {t_sh2:.3f} ms (idle {100 * idle_sh:.1f} %, over "
                              f"{len(set(mesh.devices))} card(s)), ratio of the means {t_sh / t_un:.3f}; on {card}")
            finally:
                config.set_whole_sweep(False)

        # training: float32 implicit steps on the whole-sweep plan, float64 one step, an unrolled float64 step
        config.set_whole_sweep(True)
        try:
            per_card = not label.startswith("2x")
            pair = _train_pair(torch.float32, dev, mesh, steps=SGD_STEPS,
                               ref_mesh=make_mesh(devices=[dev] * len(mesh)) if per_card else None)
            ref_name = f"{len(mesh)} shards on one card" if per_card else "unsharded"
            for step in range(SGD_STEPS):
                (lu, gu), (ls, gs) = ((pair[s][0][step], pair[s][1][step]) for s in (False, True))
                rl, rg = abs(ls - lu) / abs(lu), abs(gs - gu) / abs(gu)
                print(f"[sharded] train step {step} float32 {n}x{b} whole plan on {label}: loss {ls:.8e} vs "
                      f"{lu:.8e} (rel {rl:.3e}), d loss/d theta {gs:.6e} vs {gu:.6e} (rel {rg:.3e}; against "
                      f"{ref_name}, tol {SHARD_GRAD_RTOL_F32:.0e})")
                check(rl <= SHARD_GRAD_RTOL_F32 and rg <= SHARD_GRAD_RTOL_F32 and gs != 0.0,
                      f"sharded training step {step} off {ref_name}")
            fwd_shards = pair[True][2][0]
            check(all(s["whole_factor"] > 0 and s["whole_fwd_subst"] > 0 for s in fwd_shards),
                  f"sharded training: a shard ran no whole-sweep kernel {fwd_shards}")
            pair64 = _train_pair(torch.float64, dev, mesh)
            (lu, gu), (ls, gs) = ((pair64[s][0][0], pair64[s][1][0]) for s in (False, True))
            rl, rg = abs(ls - lu) / abs(lu), abs(gs - gu) / abs(gu)
            print(f"[sharded] train step float64 {n}x{b} on {label}: loss rel {rl:.3e}, gradient rel {rg:.3e} "
                  f"(tol {SHARD_GRAD_RTOL_F64:.0e})")
            check(rl <= SHARD_GRAD_RTOL_F64 and rg <= SHARD_GRAD_RTOL_F64, "sharded float64 training step off")
            un, ub, ui = UNROLL
            pairu = _train_pair(torch.float64, dev, mesh, shape=(un, ub), mode="unroll", iters=ui)
            (lu, gu), (ls, gs) = ((pairu[s][0][0], pairu[s][1][0]) for s in (False, True))
            rg = abs(gs - gu) / abs(gu)
            print(f"[sharded] unroll {un}x{ub} float64, {ui} LM iterations, on {label}: gradient {gs:.12e} vs "
                  f"{gu:.12e}, rel {rg:.3e} (tol {SHARD_GRAD_RTOL_F64:.0e})")
            check(rg <= SHARD_GRAD_RTOL_F64 and gs != 0.0, "sharded unrolled gradient off")
            if label.startswith("2x"):
                report["train"] = {"f32_losses": pair[True][0], "f32_grads": pair[True][1],
                                   "f32_grad_rel": [abs(a - c) / abs(c) for a, c in zip(pair[True][1], pair[False][1])],
                                   "f64_grad_rel": rg}
        finally:
            config.set_whole_sweep(False)
    return launches, report


def phase_gbp_sharded(dev, card):
    """GBP factor sharding at scripts/dryrun_gbp_shard.py's size: GBP_SHARD
    (poses, batch), the chain plus one closure (as many Between factors as
    poses, split in two on the card; the prior whole), GBP_SHARD_SWEEPS
    sweeps at message damping GBP_DAMPING and LM damping 1e-3; the Between
    launch of the normal's build against its twin on its inputs; the
    sharded delta against the unsharded one, float64 and float32, and the
    unsharded delta of a second solve, which must have the same bits."""
    import torch

    from theseus_tpu_torch import _cuda
    from theseus_tpu_torch.lie import se3
    from theseus_tpu_torch.optim.gbp import GBPNormalBuilder
    from theseus_tpu_torch.parallel import make_mesh, shard_gbp_factors
    from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

    n, b = GBP_SHARD
    launches = {k: 0 for k in KERNEL_INFO}
    report = {}

    def rel(x, ref):
        return float((x - ref).abs().max() / ref.abs().max())

    for label, devices in _mesh_devices(dev):
        mesh = make_mesh(devices=devices, axis="factors")
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[-1]
            gt, edges, meas, init = synthetic_pose_graph(n, b, seed=0, dtype=dtype, device=dev,
                                                         extra_loop_closures=False)
            closure = se3.compose(se3.inverse(gt[0]), gt[n // 2])
            obj, _ = build_pgo_objective(n, edges + [(0, n // 2)], torch.cat([meas, closure[None]]), gt[0],
                                         dtype=dtype, device=dev)
            co = obj.compile()
            values = obj.default_values(pose_values(init))
            bld = GBPNormalBuilder(co, msg_iters=GBP_SHARD_SWEEPS, msg_damping=GBP_DAMPING)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            records = {}
            t0 = time.perf_counter()
            with _recording(records):
                normal = bld.build(co.pack(values, b), co.build_aux(values, b))
            sharded = shard_gbp_factors(normal, mesh)
            delta, fail = sharded.solve(1e-3)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            fwd = dict(_cuda.launches)
            _hold_recorded(f"gbp_sharded {dn} build on {label}", records, fwd)
            want, _ = normal.solve(1e-3)
            again, _ = normal.solve(1e-3)
            dev_sh = rel(delta, want)
            tol = GBP_SHARD_TOL_F64 if dtype == torch.float64 else GBP_SHARD_TOL_F32
            ks = sorted(e[0].shape[0] for e in sharded.etas)
            print(f"[gbp_sharded] {n} poses x {b} {dn} on {label}: factor chunks {ks}, {GBP_SHARD_SWEEPS} sweeps, "
                  f"{wall:.1f} ms (build, shard, solve); delta max rel dev from the unsharded {dev_sh:.3e}; "
                  f"a second unsharded solve has the same bits: {torch.equal(again, want)}")
            if label.startswith("2x") or dtype == torch.float64:
                print(f"[gbp_sharded] held against the unsharded delta (tol {tol:.0e})")
                check(dev_sh <= tol, f"gbp_sharded {dn}: delta off the unsharded one by {dev_sh:.3e}")
            else:  # chunks of another size round otherwise in float32: held against the same chunks on one card
                one_mesh = make_mesh(devices=[dev] * len(mesh), axis="factors")
                one_card, _ = shard_gbp_factors(normal, one_mesh).solve(1e-3)
                same = rel(delta, one_card)
                print(f"[gbp_sharded] against {len(mesh)} chunks on one card: max rel dev {same:.3e} (tol {tol:.0e})")
                check(same <= tol, f"gbp_sharded {dn}: one chunk per card differs from one card by {same:.3e}")
            check(torch.equal(again, want), f"gbp_sharded {dn}: two unsharded solves differ (belief sums reordered)")
            print(f"[gbp_sharded] cross-device sums {sharded.cross_device_sums}; launches {_nonzero(fwd)}")
            check(not bool(fail.any()), f"gbp_sharded {dn}: a batch element failed")
            check(sharded.cross_device_sums > 0 and ks.count(n // len(mesh)) == len(mesh),
                  "gbp_sharded: the factor axis was left whole")
            check(fwd["between_se3"] > 0, "gbp_sharded: the Between kernel was not launched")
            if label.startswith("2x"):
                for k, v in fwd.items():
                    launches[k] += v
                report[dn] = {"delta_rel": dev_sh, "cross_device_sums": sharded.cross_device_sums, "ms": wall,
                              "between_launches": fwd["between_se3"]}
    return launches, report


# ---------------------------------------------------------------------------
# the example scripts (examples_torch/) on the card
# ---------------------------------------------------------------------------
def phase_examples(dev):
    """Every examples_torch script's main() in this process on the card, at
    its committed examples/configs/*.yaml (the scripts without one at their
    defaults): its seconds, the last lines it printed (the scripts' own
    asserts raise), the kernels it launched, and those launches against the
    twins on their inputs (`_hold_recorded`)."""
    import importlib
    import io

    import torch

    from theseus_tpu_torch import _cuda

    by_path, seconds = {}, {}
    configs = {p.stem: p for p in (ROOT / "examples" / "configs").glob("**/*.yaml")}
    scripts = sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py") if not p.name.startswith("_"))
    check(scripts == sorted(p.stem for p in (ROOT / "examples").glob("*.py") if p.name != "_config.py"),
          "examples_torch does not hold one script per examples/ script")
    for name in scripts:
        argv = (["--config", str(configs[name])] if name in configs else []) + ["--device", str(dev)]
        mod = importlib.import_module(f"examples_torch.{name}")
        buf = io.StringIO()
        records = {}
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), _recording(records):
            mod.main(argv)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)
        used = _nonzero(_cuda.launches)
        tail = " | ".join(buf.getvalue().strip().splitlines()[-2:])
        print(f"[examples] {name} {' '.join(argv[:2])}: {seconds[name]:.2f} s, launches {used}; {tail[:300]}")
        if used:
            by_path[f"example_{name}"] = dict(_cuda.launches)
            _hold_recorded(f"examples {name}", records, used)
    return by_path, seconds


# the evaluations phase: (script, argv, keyword arguments of main), each a
# cut of the script's sizes
EVALUATIONS = (
    ("vectorization_ablation", ["--sizes", "16,64", "--batch", "16"], {}),
    ("backward_modes_sweep", ["--n-poses", "16", "--batch", "4"], {}),
    ("backward_modes_tactile", ["--time-steps", "10", "--inner-iters", "3"], {}),
    ("autodiff_ablation", [], {}),
    ("time_local_cost_backward", ["--batches", "1", "256"], {}),
    ("gbp_eval", [], {"sizes": (16,)}),
    ("gbp_hw_bench", [], {"shapes": ((64, 16),)}),
)
# float32 final error of the vectorize False and True arms, the batch mean
# (each element is held at PLATEAU_RTOL_F32: float32 LM stops where its
# error stops resolving: 1.05e-3 apart per element between the arms on the
# CPU twins alone, scripts/torch_vectorize_arms.py)
EVAL_VEC_RTOL = 1e-4
# module constants of the scripts, cut for the phase: the vectorization
# window and the tactile sweep's learning run
EVAL_CUTS = {"vectorization_ablation": {"WINDOW": (2, 8)}, "backward_modes_tactile": {"LEARN_STEPS": 3}}
EVAL_GRAD_RTOL = 1e-7  # float64 mode gradient, kernels against plain twins on the card


def _eval_checks(name, mod, out, dev, argv):
    """The phase's own checks of one script's result (run with `argv`):
    {label: value}."""
    import torch

    from theseus_tpu_torch import config

    if name == "vectorization_ablation":
        worst = {}
        for n in sorted({r["poses"] for r in out}):
            errs = [r["err"].double() for r in out if r["poses"] == n]
            check(len(errs) == 3, f"evaluations: vectorization at {n} poses ran {len(errs)} arms, not 3")
            mean_dev = max(abs(float(e.mean() / errs[0].mean()) - 1.0) for e in errs[1:])
            elem_dev = max(float(_rel(e, errs[0]).max()) for e in errs[1:])
            print(f"[evaluations] vectorization {n} poses: final float32 error of the arms (batch mean) "
                  f"{[f'{float(e.mean()):.6e}' for e in errs]}, worst relative deviation {mean_dev:.3e} "
                  f"tol={EVAL_VEC_RTOL:.0e}; per batch element {elem_dev:.3e} tol={PLATEAU_RTOL_F32:.0e}")
            check(mean_dev <= EVAL_VEC_RTOL, f"evaluations: vectorize arms differ by {mean_dev:.3e} at {n} poses")
            check(elem_dev <= PLATEAU_RTOL_F32,
                  f"evaluations: a batch element's final error differs by {elem_dev:.3e} between arms at {n} poses")
            worst[n] = (mean_dev, elem_dev)
        return {"vec_arm_rel": worst, "ms": {f"{r['poses']} {r['vectorize']} {r['kernels']}": round(r["ms"], 4)
                                             for r in out}}
    if name == "backward_modes_sweep":
        rows = out[torch.float64]["rows"]
        with config.plain_path():
            opt = lambda flag, default: int(argv[argv.index(flag) + 1]) if flag in argv else default  # noqa: E731
            parts = mod.build(opt("--n-poses", 16), opt("--batch", 4), opt("--inner-iters", 10), torch.float64, dev)
            twins = [float(mod.gradient(mod.make_outer_loss(*parts, m, k or 4), mod.THETA, torch.float64, dev))
                     for m, k in mod.MODES]
        worst = 0.0
        for (label, g, rel, ms, _), want in zip(rows, twins):
            r = abs(g - want) / abs(want)
            worst = max(worst, r)
            print(f"[evaluations] backward sweep float64 {label}: kernels {g:+.12f} twins {want:+.12f} "
                  f"rel {r:.3e} tol={EVAL_GRAD_RTOL:.0e} (vs FD {rel:.2e}, {ms:.2f} ms/grad)")
        check(worst <= EVAL_GRAD_RTOL, f"evaluations: a float64 mode gradient is {worst:.3e} off its twins'")
        return {"grad_rel_vs_twins": worst,
                "ms_grad": {str(dt).split(".")[-1]: {lab: round(ms, 4) for lab, _, _, ms, _ in v["rows"]}
                            for dt, v in out.items()}}
    if name == "backward_modes_tactile":
        check(all(math.isfinite(r["loss10"]) for r in out), "evaluations: a tactile learning run diverged")
        return {r["mode"]: {"ms_grad": round(r["ms_grad"], 4), "rel_err": r["rel_err"]} for r in out}
    if name == "autodiff_ablation":
        return {f"{s} {m}": round(ms, 4) for s, m, ms in out}
    if name == "time_local_cost_backward":
        return {f"{g} {b}": [round(f, 4), round(bb, 4)] for g, b, f, bb in out}
    if name == "gbp_eval":
        return {"step": [[n, d, rels] for n, d, rels in out["step"]], "outer": out["outer"]}
    return {f"{n}x{b}": {"ms_sweep": s, "ms_outer": og, "lm_ms": lm} for n, b, s, og, lm in out}


def phase_evaluations(dev, card):
    """Every evaluations_torch script's main() in this process on the card
    at `EVALUATIONS`' sizes and `EVAL_CUTS`, its results file written into a
    temporary directory: its seconds, the kernels it launched, those
    launches against the twins on their inputs (`_hold_recorded`), and the
    phase's own checks (`_eval_checks`)."""
    import importlib
    import io
    import tempfile

    import torch

    from theseus_tpu_torch import _cuda

    scripts = sorted(p.stem for p in (ROOT / "evaluations_torch").glob("*.py") if not p.name.startswith("_"))
    check(scripts == sorted(n for n, _, _ in EVALUATIONS), "evaluations_torch does not hold the seven scripts")
    by_path, summary = {}, {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, kwargs in EVALUATIONS:
            mod = importlib.import_module(f"evaluations_torch.{name}")
            argv = argv + ["--device", str(dev)]
            buf = io.StringIO()
            records = {}
            with mock.patch.multiple(mod, OUT=Path(tmp) / mod.OUT.name, **EVAL_CUTS.get(name, {})):
                torch.cuda.synchronize()
                _cuda.reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf), _recording(records):
                    out = mod.main(argv, **kwargs)
                torch.cuda.synchronize()
                seconds = round(time.perf_counter() - t0, 3)
                used = _nonzero(_cuda.launches)
                launched = dict(_cuda.launches)
            lines = buf.getvalue().strip().splitlines()
            for line in lines:
                if not line.startswith("wrote "):
                    print(f"[evaluations] {name}: {line}")
            print(f"[evaluations] {name} {' '.join(argv)}: {seconds:.2f} s, launches {used}")
            if used:
                by_path[f"eval_{name}"] = launched
                _hold_recorded(f"evaluations {name}", records, used)
            summary[name] = {"s": seconds, **_eval_checks(name, mod, out, dev, argv)}
    return by_path, summary


def marginal_ms(solve, n_small=5, extra=20, reps=3):
    """Marginal ms per LM iteration, (t(N+K) - t(N)) / K (bench.py's
    window): solve(n, state_scale) runs n iterations from the state scaled
    by state_scale (a fresh perturbation each call) and returns the final
    error; each call is timed from a sync of every card to the next."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def run(n, i):
        sync()
        t0 = time.perf_counter()
        err = solve(n, 1.0 + 1e-7 * (i + 1))
        sync()
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(err).all()), "timing solve: non-finite error")
        return dt

    run(n_small, 0)  # warm-up
    t_small = min(run(n_small, i) for i in range(reps))
    t_large = min(run(n_small + extra, i) for i in range(reps))
    return (t_large - t_small) / extra * 1e3


def lm_iter_ms(prob, n_small=5, extra=20, reps=3):
    """`marginal_ms` of prob's LM loop (`_lm_solve`)."""
    return marginal_ms(_lm_solve(prob), n_small, extra, reps)


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


def once_ms(fn):
    """(fn(), ms of that one call by CUDA events, from an idle card)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, reps=20, warmup=3):
    """ms per call of the device work alone: the stream is held by a sleep
    kernel while the host enqueues all reps, so the wrappers' host cost
    (Python, ctypes) does not stretch the window as it does in cuda_ms.
    The sleep lasts twice the host's enqueue time; if it ended before the
    host had enqueued every call (a slow moment on the host), the window is
    taken again with a sleep twice as long, and after three tries it fails."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(3):
        torch.cuda._sleep(int(2.0 ** (attempt + 1) * host_s * SLEEP_CYCLES_PER_S) + 100_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        prefilled = not start.query()
        torch.cuda.synchronize()
        if prefilled:
            return start.elapsed_time(end) / reps
    check(False, "device_ms: the sleep ended before the timed calls were enqueued, three times")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 peak."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def factor_flops(sched, bsz, d):
    """Operations of one factorization, counted from the schedule's valid
    blocks: 2 d^3 per present update block, d^3 / 3 per POTRF, d^3 per TRSM
    row block."""
    import numpy as np

    present = (sched.upd_slots != 0) | (np.arange(sched.upd_slots.shape[2]) == 0)[None, None, :]
    present &= sched.upd_valid[:, :, None] & sched.row_valid[:, None, :]
    rows = int(sched.row_valid.sum())
    return bsz * (2 * d ** 3 * int(present.sum()) + sched.n_head * d ** 3 / 3 + (rows - sched.n_head) * d ** 3)


def subst_flops(sched, bsz, d, forward):
    """Operations of one substitution sweep: 2 d^2 per off-diagonal factor
    block it reads, d^2 per diagonal solve."""
    blocks = int(sched.upd_valid.sum()) if forward else int(sched.row_valid.sum()) - sched.n_head
    return bsz * (2 * d * d * blocks + d * d * sched.n_head)


def assembly_bound(pattern, padded):
    """Bound of one assembly: every jacobian and error read once, AtA and
    Atb written once; 2 m d^2 operations per AtA item, 2 m d per Atb item,
    with m the item's bucket's residual dimension."""
    import numpy as np

    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks_plain

    t = pattern.asm_tables
    m_src = np.array([padded[bi][1].shape[2] for bi, _ in t.sources])
    bsz, d = padded[0][1].shape[1], pattern.d
    flops = bsz * (2 * d * d * int(m_src[t.ata_items[:, 0]].sum()) + 2 * d * int(m_src[t.atb_items[:, 0]].sum()))
    inputs = [x for jacs, e in padded for x in (*jacs, e)]
    return _bound(_nbytes(*inputs, *assemble_blocks_plain(pattern, padded)), flops)


def dense_h(pattern, ata):
    """The block matrix as a dense (B, n d, n d) tensor (diagonal blocks
    symmetrised, as the factorizations read them): the library yardstick's
    input."""
    import torch

    n, d, bsz = pattern.n_vars, pattern.d, ata.shape[1]
    h = torch.zeros((bsz, n * d, n * d), dtype=ata.dtype, device=ata.device)
    for (i, j), slot in pattern.pair_slot.items():
        blk = ata[slot]
        if i == j:
            h[:, i * d:(i + 1) * d, i * d:(i + 1) * d] = 0.5 * (blk + blk.transpose(-1, -2))
        else:
            h[:, i * d:(i + 1) * d, j * d:(j + 1) * d] = blk
            h[:, j * d:(j + 1) * d, i * d:(i + 1) * d] = blk.transpose(-1, -2)
    return h


def train_step_ms(dev, whole):
    """Wall ms of one float32 training step at TRAIN: (forward, backward()),
    each ended by a sync, after one warm-up step on the same problem."""
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

    layer, poses, gt = train_problem(*TRAIN, torch.float32, dev)
    theta = torch.tensor(THETA0, dtype=torch.float32, device=dev, requires_grad=True)
    config.set_whole_sweep(whole)
    try:
        train_step(layer, poses, gt, theta)  # warm: device tables, autograd
        theta.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = layer.forward(dict(poses, w_loop=theta.reshape(1, 1)), optimizer_kwargs={"backward_mode": "implicit"})
        loss = mean_sq_local(out, gt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    finally:
        config.set_whole_sweep(False)


def phase_timing(dev, card, twin_ms, max_abs):
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.ops.between_se3 import (
        between_linearize, between_linearize_fused, between_linearize_plain)
    from theseus_tpu_torch.ops.reprojection import reprojection_linearize, reprojection_linearize_plain
    from theseus_tpu_torch.sparse.assemble_kernel import assemble_blocks, assemble_blocks_plain
    from theseus_tpu_torch.sparse.level_kernels import (
        level_bwd_subst, level_bwd_subst_plain, level_factor, level_factor_plain,
        level_fwd_subst, level_fwd_subst_plain)
    from theseus_tpu_torch.sparse.cholesky import factorize_levels
    from theseus_tpu_torch.sparse.whole import whole_bwd_subst, whole_factor, whole_fwd_subst

    iters = {}
    grid_label = "pgo grid {}x{}x{}".format(*GRID)
    for label, make, plain in (("pgo 64x16", lambda: golden_problem(torch.float32, dev), True),
                               ("pgo 256x128", lambda: synthetic_problem(256, 128, torch.float32, dev), True),
                               ("pgo 2048x8", lambda: synthetic_problem(2048, 8, torch.float32, dev), False),
                               (grid_label, lambda: grid_prob(torch.float32, dev), False),
                               ("ba 16x200x16", lambda: ba_problem(*BA_SMALL, torch.float32, dev), True),
                               ("ba 128x4000x1", lambda: ba_problem(*BA_MAIN, torch.float32, dev), True)):
        prob = make()
        row = {"kernels": lm_iter_ms(prob)}
        if label.startswith("pgo") and label != grid_label:  # a tailed graph runs the level plan only
            config.set_whole_sweep(True)
            try:
                row["whole"] = lm_iter_ms(prob)
            finally:
                config.set_whole_sweep(False)
        if plain:  # the twins' iteration is 3-5x slower and a yardstick only: one window
            with config.plain_path():
                row["plain"] = lm_iter_ms(prob, reps=1)
        iters[label] = row
        print(f"[timing] {label} float32 LM iteration: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
              + f" (kernels: level plan{' and the dense tail' if label == grid_label else ''}; marginal over "
              f"20 iterations, min of 3; plain: one window) on {card}")

    steps = {"level": [], "whole": []}
    for whole in (False, True, True, False):
        steps["whole" if whole else "level"].append(train_step_ms(dev, whole))
    train_ms = {k: {"forward": sum(f for f, _ in v) / len(v), "backward": sum(b for _, b in v) / len(v)}
                for k, v in steps.items()}
    for k, v in steps.items():
        print(f"[timing] training step {TRAIN[0]}x{TRAIN[1]} float32, {k} plan: (forward, backward()) ms "
              + ", ".join(f"({f:.3f}, {b:.3f})" for f, b in v) + f" (order level, whole, whole, level) on {card}")

    prob = synthetic_problem(*TRAIN, torch.float32, dev)
    v1, v2, meas = between_operands(prob)
    _, ata, lflat, y, x, b_perm = plain_system(prob)
    padded = padded_blocks(prob)
    pattern = prob.builder.pattern
    sched = prob.builder.sched
    lv = level_inputs(prob, ata, lflat, y, x, b_perm)
    _, w_ata, w_atb = whole_system(*TRAIN, torch.float32, dev)
    with config.plain_path():
        w_l = whole_factor(sched, w_ata)
        w_y = whole_fwd_subst(sched, w_l, w_atb)
    ba = ba_problem(*BA_MAIN, torch.float32, dev)
    rops = reprojection_operands(ba)
    ba_padded, ba_pattern = padded_blocks(ba), ba.builder.pattern
    deep = synthetic_problem(*WHOLE_SHAPES[1], torch.float32, dev)
    lv_deep = level_inputs(deep, *plain_system(deep)[1:])
    deep_w, dw_ata, dw_atb = whole_system(*WHOLE_SHAPES[1], torch.float32, dev)
    deep_sched = deep_w.builder.sched
    dw_l = factorize_levels(deep_sched, dw_ata)
    dw_y = whole_fwd_subst(deep_sched, dw_l, dw_atb)

    def plain(fn):
        def run():
            with config.plain_path():
                return fn()
        return run

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
        "reprojection": (lambda: reprojection_linearize(*rops),
                         lambda: reprojection_linearize_plain(*rops)),
        "assemble_blocks ba": (lambda: assemble_blocks(ba_pattern, ba_padded),
                               lambda: assemble_blocks_plain(ba_pattern, ba_padded)),
        "level_factor 2048x8": (lambda: [level_factor(*f) for f, _, _ in lv_deep],
                                lambda: [level_factor_plain(*f) for f, _, _ in lv_deep]),
        "level_bwd_subst 2048x8": (lambda: [level_bwd_subst(*f) for _, _, f in lv_deep],
                                   lambda: [level_bwd_subst_plain(*f) for _, _, f in lv_deep]),
        "whole_factor": (lambda: whole_factor(sched, w_ata), plain(lambda: whole_factor(sched, w_ata))),
        "whole_factor 2048x8": (lambda: whole_factor(deep_sched, dw_ata),
                                plain(lambda: whole_factor(deep_sched, dw_ata))),
        "whole_fwd_subst": (lambda: whole_fwd_subst(sched, w_l, w_atb),
                            plain(lambda: whole_fwd_subst(sched, w_l, w_atb))),
        "whole_fwd_subst 2048x8": (lambda: whole_fwd_subst(deep_sched, dw_l, dw_atb),
                                   plain(lambda: whole_fwd_subst(deep_sched, dw_l, dw_atb))),
        "whole_bwd_subst": (lambda: whole_bwd_subst(sched, w_l, w_y),
                            plain(lambda: whole_bwd_subst(sched, w_l, w_y))),
        "whole_bwd_subst 2048x8": (lambda: whole_bwd_subst(deep_sched, dw_l, dw_y),
                                   plain(lambda: whole_bwd_subst(deep_sched, dw_l, dw_y))),
        "between_se3_aos": (lambda: between_linearize_fused(v1, v2, meas),
                            lambda: between_linearize_plain(v1, v2, meas)),
    }
    times, dev_times = {}, {}
    for name, (k, p) in pairs.items():
        # the whole-sweep twins run a Python loop over the columns: seconds a
        # call at 2048 x 8, timed once in the whole-kernels phase
        p_ms = twin_ms[name] if name in twin_ms else cuda_ms(p, reps=3 if name.startswith("whole") else 20)
        times[name] = (cuda_ms(k), p_ms)
        dev_times[name] = device_ms(k)
        what = "one sweep over all levels" if name.startswith("level") else "one call"
        shape = ("BA 128x4000x1" if name in ("reprojection", "assemble_blocks ba")
                 else "PGO 2048x8" if name.endswith("2048x8") else "PGO 256x128")
        print(f"[timing] {name:<19} {shape} float32, {what}: kernel {times[name][0]:.4f} ms back to back, "
              f"{dev_times[name]:.4f} ms device (queue prefilled), plain twin {times[name][1]:.4f} ms "
              f"(CUDA events) on {card}")

    # the assembly at BA 128 x 4000 x 1 with 2, 4, 8 and 16 items a chunk
    # (the plan's ITEMS_PER_CHUNK), each checked for repeatability
    import theseus_tpu_torch.sparse.assemble_kernel as asm_mod

    chosen, sweep = asm_mod.ITEMS_PER_CHUNK, []
    try:
        for ipt in (2, 4, 8, 16):
            asm_mod.ITEMS_PER_CHUNK = ipt
            variant = copy.copy(ba_pattern)
            variant.asm_tables = asm_mod.build_assembly_tables(ba_pattern)
            _repeatable("assemble_blocks", lambda: assemble_blocks(variant, ba_padded), f"float32 BA, {ipt} a chunk")
            sweep.append(f"{ipt}: {device_ms(lambda: assemble_blocks(variant, ba_padded)) * 1e3:.1f} us")
    finally:
        asm_mod.ITEMS_PER_CHUNK = chosen
    print(f"[timing] assemble_blocks BA 128x4000x1 float32 by items a chunk (device): {', '.join(sweep)} "
          f"(the plan uses {chosen}) on {card}")
    # where that time goes: the split lists alone and the short lists alone
    # (the other outputs left unwritten; the short part alone launches in
    # blocks of 128, as a plan without split lists does)
    parts = []
    for label, split_only in (("split lists", True), ("short lists", False)):
        tables = copy.copy(ba_pattern.asm_tables)
        tables._device = {}
        if split_only:
            tables.short_ata = tables.short_ata[:0]
            tables.short_atb = tables.short_atb[:0]
        else:
            tables.split = tables.split[:0]
        variant = copy.copy(ba_pattern)
        variant.asm_tables = tables
        parts.append(f"{label} {device_ms(lambda: assemble_blocks(variant, ba_padded)) * 1e3:.1f} us")
    print(f"[timing] assemble_blocks BA 128x4000x1 float32 parts (device): {', '.join(parts)} on {card}")

    # the level factor and forward substitution per launch: the widest and
    # the deepest level of each sweep, and the floor (one column, one row,
    # one update, batch 1)
    for label, levels in (("256x128", lv), ("2048x8", lv_deep)):
        shapes = [(f[0].shape[0], f[0].shape[1], f[1].shape[1]) for f, _, _ in levels]
        widest = max(range(len(levels)), key=lambda i: shapes[i][0] * shapes[i][1])
        deepest = max(range(len(levels)), key=lambda i: shapes[i][2])
        for which, i in (("widest", widest), ("deepest", deepest)):
            f, fw = levels[i][0], levels[i][1]
            us = device_ms(lambda: level_factor(*f), reps=50) * 1e3
            us_fwd = device_ms(lambda: level_fwd_subst(*fw), reps=50) * 1e3
            print(f"[timing] {label} {which} level {i} (C, rl, ul) = {shapes[i]}: level_factor {us:.2f} us, "
                  f"level_fwd_subst {us_fwd:.2f} us per launch (device, queue prefilled) on {card}")
    d = pattern.d
    col_a1 = torch.eye(d, device=dev).expand(1, 1, 1, d, d).contiguous()
    ks1, kj1 = torch.zeros((1, 1, 1, 1, d, d), device=dev), torch.zeros((1, 1, 1, d, d), device=dev)
    floor_us = device_ms(lambda: level_factor(col_a1, ks1, kj1), reps=50) * 1e3
    fwd1 = (kj1, torch.zeros((1, 1, 1, d), device=dev), torch.zeros((1, 1, d), device=dev), col_a1[:, 0])
    floor_fwd_us = device_ms(lambda: level_fwd_subst(*fwd1), reps=50) * 1e3
    print(f"[timing] floor (C, rl, ul, B) = (1, 1, 1, 1): level_factor {floor_us:.2f} us, level_fwd_subst "
          f"{floor_fwd_us:.2f} us per launch (device, queue prefilled) on {card}")

    # the dense tail of the grid: its POTRF alone, the tail's elimination
    # (assembly of C, POTRF, scatter) and the whole factorization
    from theseus_tpu_torch.sparse import cholesky as chol

    g_prob = grid_prob(torch.float32, dev)
    g_sched = g_prob.builder.sched
    _, g_ata, g_l, g_y, g_x, g_bp = plain_system(g_prob)
    tail_t = g_sched.tail_on(dev)
    K = g_sched.tail_k
    g_dense = chol.tail_blocks_to_mat(g_l[tail_t["col_slots"]], tail_t["valid"], K, d)
    g_dense = g_dense @ g_dense.transpose(-1, -2)
    # back to back (CUDA events): each call's device time (0.5 ms and more)
    # exceeds its host time, so the queue stays full
    tail_ms = {
        "cholesky_ex": cuda_ms(lambda: torch.linalg.cholesky_ex(g_dense)),
        "tail eliminate": cuda_ms(lambda: chol._tail_dense_eliminate(g_sched, g_ata, g_l)),
        "factorize (head levels + tail)": cuda_ms(lambda: chol.factorize(g_sched, g_ata)),
    }
    print(f"[timing] grid {GRID[0]}x{GRID[1]}x{GRID[2]} float32 dense tail ({tuple(g_dense.shape)} a POTRF, "
          f"{len(g_sched.level_tables)} head levels): " + ", ".join(f"{k} {v:.4f} ms" for k, v in tail_ms.items())
          + f" (CUDA events, back to back) on {card}")
    times["tail_update"], dev_times["tail_update"], tail_update_bound = tail_update_timing(dev, card, max_abs)
    # row 4b over the grid's head levels, whose columns have long row lists
    # (the chains' have at most 3 rows)
    g_bwd = [bw for _, _, bw in level_inputs(g_prob, g_ata, g_l, g_y, g_x, g_bp)]
    times["level_bwd_subst grid"] = (cuda_ms(lambda: [level_bwd_subst(*bw) for bw in g_bwd]),
                                     cuda_ms(lambda: [level_bwd_subst_plain(*bw) for bw in g_bwd]))
    dev_times["level_bwd_subst grid"] = device_ms(lambda: [level_bwd_subst(*bw) for bw in g_bwd])
    print(f"[timing] level_bwd_subst grid {GRID[0]}x{GRID[1]}x{GRID[2]} float32, one sweep of the {len(g_bwd)} head "
          f"levels (rl {[bw[0].shape[1] for bw in g_bwd]}): kernel {times['level_bwd_subst grid'][0]:.4f} ms back "
          f"to back, {dev_times['level_bwd_subst grid']:.4f} ms device (queue prefilled), plain twin "
          f"{times['level_bwd_subst grid'][1]:.4f} ms (CUDA events) on {card}")

    # the redesigned rows 5, 8 and 4b beside their first designs' device times
    # (PERF.md, the previous design's last measurement, same card model and limit)
    for name, first in FIRST_DESIGN_DEVICE_MS.items():
        shape = ("BA 128x4000x1" if name == "reprojection" else "grid {}x{}x{}".format(*GRID)
                 if name.endswith("grid") else "PGO 2048x8" if name.endswith("2048x8") else "PGO 256x128")
        print(f"[timing] {name:<20} {shape} float32: {dev_times[name]:.4f} ms device now, first design "
              f"{first:.4f} ms device (PERF.md); back to back now {times[name][0]:.4f} ms on {card}")

    # library yardsticks on the densified H: one PyTorch call each, timed
    # here only; the port never calls them
    h = dense_h(pattern, w_ata)
    l_dense = torch.linalg.cholesky_ex(h)[0]
    rhs = prob.builder.flatten(w_atb)[..., None]
    library = {
        "cholesky_ex": cuda_ms(lambda: torch.linalg.cholesky_ex(h), reps=5),
        "solve_triangular lower": cuda_ms(lambda: torch.linalg.solve_triangular(l_dense, rhs, upper=False), reps=5),
        "solve_triangular upper": cuda_ms(
            lambda: torch.linalg.solve_triangular(l_dense.transpose(-1, -2), rhs, upper=True), reps=5),
    }
    print(f"[timing] library yardsticks on the dense H {tuple(h.shape)} float32: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in library.items()) + f" on {card}")
    del h, l_dense
    # the grid's: the transposed solve with its dense L, the right-hand side
    # its Atb (the head and the tail in one call)
    l_dense = torch.linalg.cholesky_ex(dense_h(g_prob.builder.pattern, g_ata))[0]
    rhs = g_prob.builder.flatten(g_bp[g_sched.on(dev)[1]])[..., None]
    library["solve_triangular upper grid"] = cuda_ms(
        lambda: torch.linalg.solve_triangular(l_dense.transpose(-1, -2), rhs, upper=True), reps=5)
    print(f"[timing] library yardstick on the grid's dense L {tuple(l_dense.shape)} float32: solve_triangular "
          f"upper {library['solve_triangular upper grid']:.4f} ms on {card}")
    del l_dense

    # bounds from this run's inputs
    d, bsz = pattern.d, v1.shape[1]
    j1, j2, err = between_linearize_plain(v1, v2, meas)
    between = _bound(_nbytes(v1, v2, meas, j1, j2, err), BETWEEN_FLOPS * v1.shape[0] * bsz)
    rops_out = reprojection_linearize_plain(*rops)
    fac_out = sum(_nbytes(f[0]) for f, _, _ in lv)
    bounds = {
        "between_se3": between,
        "between_se3_aos": between,
        "assemble_blocks": assembly_bound(pattern, padded),
        "assemble_blocks ba": assembly_bound(ba_pattern, ba_padded),
        "level_factor": _bound(sum(_nbytes(*f) for f, _, _ in lv) + fac_out, factor_flops(sched, bsz, d)),
        "level_factor 2048x8": _bound(sum(_nbytes(*f) + _nbytes(f[0]) for f, _, _ in lv_deep),
                                      factor_flops(deep.builder.sched, WHOLE_SHAPES[1][1], d)),
        "level_fwd_subst": _bound(sum(_nbytes(*fw) + _nbytes(fw[2]) for _, fw, _ in lv),
                                  subst_flops(sched, bsz, d, True)),
        "level_bwd_subst": _bound(sum(_nbytes(*bw) + _nbytes(bw[2]) for _, _, bw in lv),
                                  subst_flops(sched, bsz, d, False)),
        "level_bwd_subst 2048x8": _bound(sum(_nbytes(*bw) + _nbytes(bw[2]) for _, _, bw in lv_deep),
                                         subst_flops(deep.builder.sched, WHOLE_SHAPES[1][1], d, False)),
        "reprojection": _bound(_nbytes(*rops, *rops_out), REPROJECTION_FLOPS * rops[0].shape[0] * rops[0].shape[1]),
        "whole_factor": _bound(_nbytes(w_ata, w_l), factor_flops(sched, bsz, d)),
        "whole_factor 2048x8": _bound(_nbytes(dw_ata) + (deep_sched.sym.nnz_l + 1) * dw_ata[0].numel() * 4,
                                      factor_flops(deep_sched, WHOLE_SHAPES[1][1], d)),
        "whole_fwd_subst": _bound(_nbytes(w_l, w_atb, w_y), subst_flops(sched, bsz, d, True)),
        "whole_fwd_subst 2048x8": _bound(_nbytes(dw_l, dw_atb, dw_y), subst_flops(deep_sched, WHOLE_SHAPES[1][1], d, True)),
        "whole_bwd_subst": _bound(_nbytes(w_l, w_y, w_y), subst_flops(sched, bsz, d, False)),
        "whole_bwd_subst 2048x8": _bound(_nbytes(dw_l, dw_y, dw_y), subst_flops(deep_sched, WHOLE_SHAPES[1][1], d, False)),
        "level_bwd_subst grid": _bound(sum(_nbytes(*bw) + _nbytes(bw[2]) for bw in g_bwd),
                                       subst_flops(g_sched, GRID[2], d, False)),
        "tail_update": tail_update_bound,
    }
    lib = {"level_factor": library["cholesky_ex"], "whole_factor": library["cholesky_ex"],
           "level_fwd_subst": library["solve_triangular lower"],
           "whole_fwd_subst": library["solve_triangular lower"],
           "level_bwd_subst": library["solve_triangular upper"],
           "level_bwd_subst grid": library["solve_triangular upper grid"],
           "whole_bwd_subst": library["solve_triangular upper"]}
    for name, (bms, by) in bounds.items():
        print(f"[timing] bound {name:<19} {bms:.4f} ms ({by}); kernel {times[name][0]:.4f} ms back to back, "
              f"{dev_times[name]:.4f} ms device on {card}")
    return iters, times, dev_times, train_ms, bounds, lib


def tail_update_timing(dev, card, max_abs):
    """`tail_update` at TAIL_UPDATE_GRID, float32 and float64: two launches
    bitwise equal, against the plain twin (in slices), max_abs["tail_update"]
    filled; then float32 timed back to back, as device time and against the
    twin at the whole batch. Returns ((kernel ms, twin ms), device ms,
    bound)."""
    import numpy as np
    import torch

    from theseus_tpu_torch import config
    from theseus_tpu_torch.sparse.assemble import apply_block_damping, assemble
    from theseus_tpu_torch.sparse.cholesky import factorize
    from theseus_tpu_torch.sparse.level_kernels import tail_update

    rows, cols, batch = TAIL_UPDATE_GRID
    max_abs["tail_update"] = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        prob = Problem(*grid_problem(rows, cols, batch, dtype, dev)[:2])
        sched = prob.builder.sched
        with config.plain_path():
            ata, _ = assemble(prob.builder.pattern, prob.co.linearize_blocks(prob.state, prob.aux))
            ata = apply_block_damping(prob.builder.pattern, ata, 1e-3, False, 1e-8)
        lflat = factorize(sched, ata)
        note = f"{rows}x{cols}x{batch} K={sched.tail_k}"
        got = _repeatable("tail_update", lambda: (tail_update(sched, ata, lflat),), f"{dn} {note}")[0]
        with config.plain_path():
            want = torch.cat([tail_update(sched, ata[:, s:s + TAIL_UPDATE_SLICE], lflat[:, s:s + TAIL_UPDATE_SLICE])
                              for s in range(0, batch, TAIL_UPDATE_SLICE)])
        max_abs["tail_update"][dn] = _dev_report("tail_update", dn, got, want, note)
        del got, want
        if dtype == torch.float32:
            kernel = lambda: tail_update(sched, ata, lflat)  # noqa: E731
            ms, dev_ms = cuda_ms(kernel), device_ms(kernel)
            torch.cuda.empty_cache()
            with config.plain_path():
                twin_ms = cuda_ms(kernel, reps=2, warmup=1)
            torch.cuda.empty_cache()
            d, K, isz = ata.shape[-1], sched.tail_k, ata.element_size()
            blocks = len(np.unique(sched.tail_pairs)) + len(np.unique(sched.tail_out[:, 2]))
            bound = _bound((batch * (K * d) ** 2 + blocks * batch * d * d) * isz,
                           2 * d ** 3 * len(sched.tail_pairs) * batch)
            print(f"[timing] tail_update {note} float32, {len(sched.tail_out)} output blocks, "
                  f"{len(sched.tail_pairs)} pairs: kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms device (queue "
                  f"prefilled), plain twin {twin_ms:.4f} ms (CUDA events), bound {bound[0]:.4f} ms ({bound[1]}) "
                  f"on {card}")
            result = ((ms, twin_ms), dev_ms, bound)
        del prob, ata, lflat
    return result


# ---------------------------------------------------------------------------
# phase 6: where the time goes
# ---------------------------------------------------------------------------
def _synced_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_profile(dev, card, n_iters=5):
    """Per path: synced stage times of one LM iteration, then torch.profiler
    over n_iters iterations: wall, device busy time (sum of device kernel
    time), launches and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theseus_tpu_torch.sparse.assemble import assemble

    from theseus_tpu_torch import config

    for label, prob in (("pgo 256x128", synthetic_problem(256, 128, torch.float32, dev)),
                        ("pgo 256x128 whole", synthetic_problem(256, 128, torch.float32, dev)),
                        ("pgo grid {}x{}x{}".format(*GRID), grid_prob(torch.float32, dev)),
                        ("ba {}x{}x{}".format(*BA_SMALL), ba_problem(*BA_SMALL, torch.float32, dev)),
                        ("ba {}x{}x{}".format(*BA_MAIN), ba_problem(*BA_MAIN, torch.float32, dev))):
        opt, opts, co, bld = prob.opt, prob.opt.opts, prob.co, prob.builder
        state, aux = prob.state, prob.aux
        config.set_whole_sweep(label.endswith("whole"))
        with torch.no_grad():
            blocks = co.linearize_blocks(state, aux)
            ns = bld.build(state, aux)
            delta, _ = ns.solve(1e-3, opts.ellipsoidal_damping)
            stages = {
                "linearize": lambda: co.linearize_blocks(state, aux),
                "assemble": lambda: assemble(bld.pattern, blocks),
                "solve": lambda: ns.solve(1e-3, opts.ellipsoidal_damping),
                "retract": lambda: co.retract(state, delta),
                "error": lambda: co.error_metric(state, aux),
            }
            line = ", ".join(f"{k} {_synced_ms(f):.3f}" for k, f in stages.items())
            print(f"[profile] {label} stages (ms, each synced, mean of 5): {line} on {card}")
            carry = opt.init_carry(state, aux, opts)
            carry = opt.run_scan(carry, aux, 2, opts)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                carry = opt.run_scan(carry, aux, n_iters, opts)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        config.set_whole_sweep(False)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        by_name = {}
        for e in events:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        print(f"[profile] {label} {n_iters} iterations: wall {wall:.2f} ms, device busy {busy:.2f} ms "
              f"(idle {100 * (1 - busy / wall):.1f} %), {len(events) / n_iters:.0f} device kernels per "
              f"iteration, on {card}")
        for name, (t, n) in top:
            print(f"[profile]   {t:9.3f} ms  {n:5d}x  {t / n * 1e3:9.1f} us/launch  {name[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "theseus_tpu_torch" / "__init__.py").exists() or not all(
            p.exists() for p in (GOLDEN, BA_GOLDEN, PGO2D_GOLDEN, MANHATTAN, TACTILE_GOLDEN,
                                 ROOT / "examples_torch" / "_config.py", ROOT / "examples" / "configs",
                                 ROOT / "evaluations_torch" / "_common.py")):
        print("chip_smoke: run from the root of a theseus_tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 2)
        return out

    timed("build", phase_build)
    max_abs = timed("kernels", phase_kernels, dev)
    max_abs = timed("ba_kernels", phase_ba_kernels, dev, max_abs)
    intr_launches, intr = timed("ba_intr", phase_ba_intr, dev, card)
    max_abs.update(intr["max_abs"])
    max_abs, twin_ms = timed("whole_kernels", phase_whole_kernels, dev, max_abs)
    launches = {"ba_intr": intr_launches, "pgo": timed("slice", phase_slice, dev),
                "ba": timed("ba_slice", phase_ba_slice, dev),
                "train": timed("train", phase_train, dev), "aos_entry": timed("aos_entry", phase_aos_entry, dev),
                "tail": timed("tail", phase_tail, dev)}
    launches["ba_train"], ba_train_ms = timed("ba_train", phase_ba_train, dev)
    launches["dlm"], dlm_ms = timed("dlm", phase_dlm, dev)
    timed("g2o", phase_g2o, dev)
    ik = timed("ik", phase_ik, dev, card)
    launches["dense_pgo"], dense_ms = timed("dense_pgo", phase_dense_pgo, dev)
    launches["pgo2d"], pgo2d = timed("pgo2d", phase_pgo2d, dev, card)
    launches["planning"], plan = timed("planning", phase_planning, dev, card)
    if plan["whole_launches"]:
        launches["planning_whole"] = plan["whole_launches"]
    launches["tactile"], tac = timed("tactile", phase_tactile, dev, card)
    launches["pcg"], pcg = timed("pcg", phase_pcg, dev, card)
    launches["dcem"], dcem = timed("dcem", phase_dcem, dev, card)
    launches["gbp"], gbp = timed("gbp", phase_gbp, dev, card)
    homog = timed("homography", phase_homography, dev, card)
    launches["sharded"], sharded = timed("sharded", phase_sharded, dev, card)
    launches["gbp_sharded"], gbp_sharded = timed("gbp_sharded", phase_gbp_sharded, dev, card)
    example_launches, example_s = timed("examples", phase_examples, dev)
    launches.update(example_launches)
    eval_launches, evals = timed("evaluations", phase_evaluations, dev, card)
    launches.update(eval_launches)
    iters, times, dev_times, train_ms, bounds, library = timed("timing", phase_timing, dev, card, twin_ms, max_abs)
    for merged, part in ((times, "times"), (dev_times, "dev_times"), (bounds, "bounds")):
        merged.update(intr[part])
    timed("profile", phase_profile, dev, card)
    check("jax" not in sys.modules and "theseus_tpu" not in sys.modules, "jax was imported")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        check(bool(by_path), f"{name} was never launched by a main path")
        bound_ms, bound_by = bounds[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_abs[name]["float32"], "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library.get(name),
            "device_ms": dev_times[name],
        }
        if name == "level_bwd_subst":  # the grid's head levels, beside 256 x 128's
            entry["ms_grid"], entry["plain_ms_grid"] = times["level_bwd_subst grid"]
            entry["device_ms_grid"] = dev_times["level_bwd_subst grid"]
            entry["bound_ms_grid"], _ = bounds["level_bwd_subst grid"]
            entry["library_ms_grid"] = library["level_bwd_subst grid"]
        if name == "assemble_blocks":  # the BA main path's shape, beside PGO's
            entry["ms_ba"], entry["plain_ms_ba"] = times["assemble_blocks ba"]
            entry["device_ms_ba"] = dev_times["assemble_blocks ba"]
            entry["bound_ms_ba"], entry["bound_by_ba"] = bounds["assemble_blocks ba"]
        if name in pgo2d["times"]:  # the 2-D graph's d = 3, batch-1 shapes; one sweep for a level kernel
            (entry["ms_pgo2d"], entry["plain_ms_pgo2d"], entry["device_ms_pgo2d"]) = pgo2d["times"][name]
            entry["bound_ms_pgo2d"], entry["bound_by_pgo2d"] = pgo2d["bounds"][name]
            entry["library_ms_pgo2d"] = pgo2d["library"].get(name)
            entry["max_abs_err_pgo2d"] = pgo2d["max_abs"][name]["float32"]
        for b, tb in plan["times"].items():  # the planner's d = 2 shapes at each batch; a level kernel: one sweep
            if name in tb:
                entry[f"ms_plan{b}"], entry[f"plain_ms_plan{b}"], entry[f"device_ms_plan{b}"] = tb[name]
                entry[f"bound_ms_plan{b}"], entry[f"bound_by_plan{b}"] = plan["bounds"][b][name]
                entry[f"library_ms_plan{b}"] = plan["library"][b].get(name)
        if name in plan["max_abs"]:
            entry["max_abs_err_plan"] = plan["max_abs"][name]["float32"]
        if name in tac["times"]:  # the tactile d = 3, batch-64 shapes; a level kernel: one sweep
            entry["ms_tactile"], entry["plain_ms_tactile"], entry["device_ms_tactile"] = tac["times"][name]
            entry["bound_ms_tactile"], entry["bound_by_tactile"] = tac["bounds"][name]
            entry["library_ms_tactile"] = tac["library"].get(name)
            entry["max_abs_err_tactile"] = tac["max_abs"][name]["float32"]
        if name in ("level_factor", "level_bwd_subst", "whole_factor", "whole_fwd_subst",
                    "whole_bwd_subst"):  # the deep and narrow shape
            entry["ms_2048x8"], entry["plain_ms_2048x8"] = times[f"{name} 2048x8"]
            entry["device_ms_2048x8"] = dev_times[f"{name} 2048x8"]
            entry["bound_ms_2048x8"], _ = bounds[f"{name} 2048x8"]
        kernels.append(entry)
    print(json.dumps({"lm_iter_ms": iters, "train_step_ms": train_ms, "ba_train_step_ms": ba_train_ms,
                      "dlm_step_ms": dlm_ms, "ik_serving": ik, "dense_lm_iter_ms_64x16": dense_ms,
                      "pgo2d_lm_iter_ms": pgo2d["lm_iter_ms"], "pgo2d_idle": pgo2d["idle"],
                      "planning_lm_iter_ms": plan["lm_iter_ms"], "planning_idle": plan["idle"],
                      "planning_serving": plan["serving"], "planning_samples_ms": plan["samples_ms"],
                      "planning_covariances_ms": plan["covariances_ms"], "tactile_lm_iter_ms": tac["lm_iter_ms"],
                      "tactile_idle": tac["idle"], "tactile_mode_ms": tac["mode_ms"],
                      "tactile_sgd_losses": tac["sgd_losses"], "pcg_lm_iter_ms": pcg["lm_iter_ms"],
                      "pcg_idle": pcg["idle"], "dcem": dcem, "gbp": gbp, "homography": homog,
                      "pgo2d_symbolic_s": pgo2d["symbolic_s"], "sharded": sharded, "gbp_sharded": gbp_sharded,
                      "examples_s": example_s, "evaluations": evals}))
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; seconds a phase: {json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
