"""Faults planted under the timed path, to see `correct` come out false.

Each takes a built problem (configs/<config>.py `Problem`) and breaks its
timed call in place; run.run_cell(fault=...) applies one before the
window. The tests plant them on the CPU at a tiny size, control.py on the
card at the cell's own size. A cell on one chip has no exchange between
chips to leave out.
"""

from __future__ import annotations

import torch


def unchanged(prob):
    """The step returns its state unchanged: a solve hands back its
    inputs, a training step leaves the parameter where it was."""
    if hasattr(prob, "sgd"):
        prob.sgd.step = lambda *a, **k: None
        return
    solve = prob.solve

    def broken(i):
        _, info = solve(i)
        return prob.inputs(i), info
    prob.solve = broken


def half_batch(prob):
    """Half of the batch left out: a solve returns the second half of the
    batch unsolved (its inputs); a training loss is the mean over the first
    half."""
    if hasattr(prob, "sgd"):
        from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

        def broken_loss(out):
            half = prob.gt.shape[1] // 2
            return mean_sq_local({k: v[:half] for k, v in out.items() if k.startswith("pose_")}, prob.gt[:, :half])
        prob.loss = broken_loss
        return
    if prob.traffic["batch"] < 2:
        raise ValueError("a batch of one has no half to leave out")
    solve, axis = prob.solve, prob.BATCH_AXIS

    def broken(i):
        out, info = solve(i)
        inp = prob.inputs(i)
        half = prob.traffic["batch"] // 2
        out = dict(out)
        for k, v in inp.items():
            out[k] = torch.cat([out[k].narrow(axis, 0, half), v.narrow(axis, half, v.shape[axis] - half)], axis)
        return out, info
    prob.solve = broken


def altered(prob):
    """An answer altered where it is produced: a solve's first output
    shifted by 0.1 in its first entry; a training loss scaled by 1.01."""
    if hasattr(prob, "sgd"):
        loss = prob.loss
        prob.loss = lambda out: 1.01 * loss(out)
        return
    solve = prob.solve

    def broken(i):
        out, info = solve(i)
        k = next(iter(prob.inputs(i)))
        v = out[k].clone()
        v.view(-1)[0] += 0.1
        out = dict(out)
        out[k] = v
        return out, info
    prob.solve = broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
