"""Autodiff-mode ablation: analytic against forward- and reverse-mode cost jacobians (the port of evaluations/autodiff_ablation.py).

ms of one `CompiledObjective.linearize_blocks` call (the minimum of 5
synced calls after a warm-up) on two residual shapes:

- reprojection (dim 2, an SE3 camera and a Point3, 64 costs at batch 8):
  the analytic `Reprojection` (its kernel on the card), and
  `AutoDiffCostFunction` with autograd_mode "fwd" and "rev";
- a photometric patch (dim 64, one 8-vector, 32 costs at batch 8): "fwd"
  and "rev".

The targets and patches are standard normal draws from numpy seeds (the
JAX script draws them with jax.random). Runs on the card unless --device
cpu is given.

    python evaluations_torch/autodiff_ablation.py [--device cpu]

Writes evaluations_torch/results_autodiff.md (a section per device,
replaced by the next run on it).
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from evaluations_torch import _common
from theseus_tpu_torch.lie import se3

OUT = pathlib.Path(__file__).resolve().parent / "results_autodiff.md"


def linearizer(obj, values):
    """fn(): one linearize_blocks call on the packed values."""
    co = obj.compile()
    b = co.resolve_batch_size(values)
    vals = obj.default_values(values)
    state, aux = co.pack(vals, b), co.build_aux(vals, b)
    return lambda: co.linearize_blocks(state, aux)


def time_linearize(obj, values, device, reps=5):
    f = linearizer(obj, values)
    _common.synced_s(f, device)
    return min(_common.synced_s(f, device)[1] for _ in range(reps)) * 1e3


def reprojection_objective(mode, n=64, batch=8, device=None, uv=None, dtype=torch.float32):
    """(objective, values): n costs between one camera and n points, each
    against the target uv (batch, 2) (numpy seed 0 when None); mode
    "analytic", "fwd" or "rev"."""
    uv = np.random.default_rng(0).standard_normal((batch, 2)) if uv is None else uv
    cam = tt.SE3(name="cam")
    pts = [tt.Point3(name=f"p{i}") for i in range(n)]
    obj = tt.Objective(dtype=dtype, device=device)

    def err_fn(optim, aux):
        g, p = optim
        (target,) = aux
        pc = se3.transform(g, p)
        return -pc[:2] / pc[2:] - target

    for i, p in enumerate(pts):
        if mode == "analytic":
            obj.add(tt.Reprojection(cam, p, tt.Variable(np.full((batch, 1), 1.0), name=f"f{i}"),
                                    tt.Variable(uv, name=f"uv{i}"), name=f"c{i}"))
        else:
            obj.add(tt.AutoDiffCostFunction([cam, p], 2, err_fn, aux_vars=[tt.Variable(uv, name=f"uv{i}")],
                                            autograd_mode=mode, name=f"c{i}"))
    dt, dev = obj.dtype, obj.device
    vals = {"cam": torch.eye(3, 4, dtype=dt, device=dev).expand(batch, 3, 4)}
    for i in range(n):
        vals[f"p{i}"] = torch.tensor([[0.1 * i - 3, 0.0, 5.0]], dtype=dt, device=dev).expand(batch, 3)
    return obj, vals


def photometric_objective(mode, n=32, batch=8, patch=8, device=None, pix=None, dtype=torch.float32):
    """(objective, values): n toy homography-warped photometric residuals of
    one 8-vector h, each over a patch (batch, patch^2, 3) of pixel
    coordinates and intensities (numpy seed 1, drawn in order, when pix is
    None; else pix[i])."""
    if pix is None:
        rng = np.random.default_rng(1)
        pix = [rng.standard_normal((batch, patch * patch, 3)) for _ in range(n)]
    h = tt.Vector(8, name="h")
    obj = tt.Objective(dtype=dtype, device=device)

    def err_fn(optim, aux):
        (h8,) = optim
        (px,) = aux
        xy = px[:, :2]
        w = 1.0 + xy @ h8[6:8]
        uv = xy @ h8[:2].reshape(2, 1) + h8[2] + xy @ h8[3:5].reshape(2, 1) + h8[5]
        return (uv / w[:, None]).reshape(-1)[: px.shape[0]] - px[:, 2]

    for i in range(n):
        obj.add(tt.AutoDiffCostFunction([h], patch * patch, err_fn, aux_vars=[tt.Variable(pix[i], name=f"pix{i}")],
                                        autograd_mode=mode, name=f"c{i}"))
    h0 = torch.zeros((batch, 8), dtype=obj.dtype, device=obj.device)
    h0[:, 0] = 1.0
    h0[:, 4] = 1.0
    return obj, {"h": h0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    a = p.parse_args(argv)
    dev = _common.device_of(a.device)
    card = _common.card_line(dev)

    rows = []
    for mode in ("analytic", "fwd", "rev"):
        obj, vals = reprojection_objective(mode, device=dev)
        rows.append(("reprojection dim2", mode, time_linearize(obj, vals, dev)))
        print(rows[-1], flush=True)
    for mode in ("fwd", "rev"):
        obj, vals = photometric_objective(mode, device=dev)
        rows.append(("photometric dim64", mode, time_linearize(obj, vals, dev)))
        print(rows[-1], flush=True)

    notes = ("ms of one linearize_blocks call, float32, the minimum of 5 synced calls after a warm-up. "
             "analytic: the Reprojection cost (on the card its CUDA kernel); fwd / rev: AutoDiffCostFunction "
             "(torch.func jacfwd / jacrev through the retract, vmapped over costs and batch).")
    _common.write_results(
        OUT, "Autodiff ablation, theseus_tpu_torch",
        [_common.Section(f"autodiff ablation ({dev.type})", notes, ["residual", "mode", "linearize ms"],
                         [[s, m, f"{ms:.3f}"] for s, m, ms in rows])],
        card)
    return rows


if __name__ == "__main__":
    main()
