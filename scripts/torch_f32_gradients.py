"""How far theseus_tpu_torch's float32 training gradients sit from float64, and why: the numbers behind chip_smoke.py's float32 gradient checks.

Three measurements, each float32 against float64 on the same problem:

- `ba_pins`: the robust (Huber) bundle-adjustment training step of
  chip_smoke.py (`ba_train_layer`: 5 % outliers, visibility 0.4, the log
  radius at 0), with the scale fixed either by camera 1 pinned at the
  gauge's weight 1e4 or by landmark 0 pinned at chip_smoke.BA_SCALE_PIN.
  For each: the float64 LM solve; the implicit step (final undamped
  Gauss-Newton step and backward()) taken from that float64 solution in
  float64 and in float32, which isolates the step from the float32 solve;
  the whole float32 step against the whole float64 step; and how much the
  final step moves the outer loss.
- `pgo_dlm`: the DLM step of the flagship PGO training problem
  (chip_smoke.train_problem), float32 against float64.
- `ba_dlm`: the DLM step of the robust BA problem with the landmark pin,
  float32 against float64 (its perturbed solves move the state by
  eps H^{-1} u, below float32's resolution when H is large).

On the card (the default, as for every entry point of the package) the
kernels run; with --device cpu every kernel runs its plain twin. The BA shape defaults to 128 x 1000 x 1: every
camera of chip_smoke's 128 x 4000 x 1 cell and a quarter of its points.
Run from the repository root:

    python3 scripts/torch_f32_gradients.py [--device cpu|cuda] [--ba 128 1000 1] [--pgo 64 16]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _rel(a, b):
    return abs(a - b) / abs(b)


def _ba_layer(shape, dtype, dev, pin, iters):
    """chip_smoke's robust BA training problem with the scale fixed by
    `pin`: (layer, inputs, ground-truth cameras, log radius leaf)."""
    import torch

    import chip_smoke as cs
    import theseus_tpu_torch as tt
    from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective, synthetic_ba

    cams, pts, batch = shape
    prob = synthetic_ba(cams, pts, batch=batch, seed=0, visibility=cs.BA_VISIBILITY, outlier_fraction=cs.BA_OUTLIERS,
                        dtype=dtype, device=dev)
    log_radius = torch.full((1, 1), cs.BA_LOG_RADIUS0, dtype=dtype, device=dev, requires_grad=True)
    obj, cam_fam, pt_fam = build_ba_objective(prob, dtype=dtype, device=dev, robust_loss_cls=tt.HuberLoss,
                                              log_loss_radius=log_radius, gauge_target=prob.gt_poses[0])
    if pin == "camera1":
        obj.add(tt.Local(cam_fam[1], prob.gt_poses[1].cpu().numpy(), tt.ScaleCostWeight(1e4), name="scale_pin"))
    else:
        obj.add(tt.Local(pt_fam[0], prob.gt_points[0].cpu().numpy(), tt.ScaleCostWeight(cs.BA_SCALE_PIN),
                         name="scale_pin"))
    layer = tt.TheseusLayer(tt.LevenbergMarquardt(obj, max_iterations=iters, **cs.BA_OPTS))
    return layer, ba_values(prob), prob.gt_poses, log_radius


def _ba_step(shape, dtype, dev, pin, mode="implicit", start=None):
    """(outer loss, d loss / d log_radius) of one training step; start:
    from these values with no LM iteration, so that only the implicit
    step's final Gauss-Newton step runs."""
    import chip_smoke as cs

    layer, inputs, gt, log_radius = _ba_layer(shape, dtype, dev, pin, cs.ITERS if start is None else 0)
    if start is not None:
        inputs = {k: v.to(dtype) for k, v in start.items()}
    out, _ = layer.forward(inputs, optimizer_kwargs={"backward_mode": mode})
    loss = cs.ba_outer_loss(out, gt)
    loss.backward()
    return float(loss.detach()), float(log_radius.grad)


def ba_pins(shape, dev):
    import torch

    import chip_smoke as cs

    for pin in ("camera1", "landmark0"):
        layer, inputs, gt, _ = _ba_layer(shape, torch.float64, dev, pin, cs.ITERS)
        with torch.no_grad():
            out, _ = layer.forward(inputs)
            solve_loss = float(cs.ba_outer_loss(out, gt))
        sol = {k: out[k] for k in ("cam", "pt")}
        l64, g64 = _ba_step(shape, torch.float64, dev, pin, start=sol)
        _, g32 = _ba_step(shape, torch.float32, dev, pin, start=sol)
        _, w64 = _ba_step(shape, torch.float64, dev, pin)
        _, w32 = _ba_step(shape, torch.float32, dev, pin)
        print(f"[ba {pin}] {'x'.join(map(str, shape))}: outer loss at the float64 solution {solve_loss:.6e}, after "
              f"its final undamped step {l64:.6e} (moved {_rel(l64, solve_loss):.3e}); the step from that "
              f"solution, d loss/d log_radius: float64 {g64:.9e}, float32 {g32:.9e} (rel {_rel(g32, g64):.3e}); "
              f"the whole step: float64 {w64:.9e}, float32 {w32:.9e} (rel {_rel(w32, w64):.3e})")


def pgo_dlm(shape, dev):
    import torch

    import chip_smoke as cs
    from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

    grads = {}
    for dtype in (torch.float64, torch.float32):
        layer, poses, gt = cs.train_problem(*shape, dtype, dev)
        theta = torch.tensor(cs.THETA0, dtype=dtype, device=dev, requires_grad=True)
        out, _ = layer.forward(dict(poses, w_loop=theta.reshape(1, 1)), optimizer_kwargs={"backward_mode": "dlm"})
        mean_sq_local(out, gt).backward()
        grads[dtype] = float(theta.grad)
    g64, g32 = grads[torch.float64], grads[torch.float32]
    print(f"[pgo dlm] {'x'.join(map(str, shape))}: d loss/d theta float64 {g64:.9e}, float32 {g32:.9e} "
          f"(rel {_rel(g32, g64):.3e})")


def ba_dlm(shape, dev):
    import torch

    _, g64 = _ba_step(shape, torch.float64, dev, "landmark0", mode="dlm")
    _, g32 = _ba_step(shape, torch.float32, dev, "landmark0", mode="dlm")
    print(f"[ba dlm] {'x'.join(map(str, shape))}: d loss/d log_radius float64 {g64:.9e}, float32 {g32:.9e} "
          f"(rel {_rel(g32, g64):.3e})")


def main() -> int:
    from theseus_tpu_torch import config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="default: the card (config.default_device())")
    p.add_argument("--ba", type=int, nargs=3, default=(128, 1000, 1), metavar=("CAMS", "POINTS", "BATCH"))
    p.add_argument("--pgo", type=int, nargs=2, default=(64, 16), metavar=("POSES", "BATCH"))
    a = p.parse_args()
    dev = config.resolve_device(a.device)
    import chip_smoke as cs

    name = cs.card_line() if dev.type == "cuda" else "plain PyTorch twins"
    print(f"[device] {dev} ({name})")
    ba_pins(tuple(a.ba), dev)
    pgo_dlm(tuple(a.pgo), dev)
    ba_dlm(tuple(a.ba), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
