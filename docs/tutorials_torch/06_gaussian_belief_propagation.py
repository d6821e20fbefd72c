# %% [markdown]
# # Tutorial 6: Gaussian belief propagation and posterior marginals
#
# (the PyTorch port of docs/tutorials/06_gaussian_belief_propagation.py)
#
# The direct solvers (GN or LM with a Cholesky) return the MAP point
# estimate. Gaussian belief propagation solves the same nonlinear
# least-squares problem by *message passing on the factor graph*, and as a
# by-product gives each variable's posterior **marginal information**: the
# uncertainty of every pose, which a direct solver gives only through the
# inverse of the Hessian. The schedule is synchronous: every message of a
# sweep in one batched step.
#
# Run: `python docs/tutorials_torch/06_gaussian_belief_propagation.py [--device cpu]`

# %%
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np
import torch

import theseus_tpu_torch as tt
from theseus_tpu_torch import config
from theseus_tpu_torch.lie import se2

parser = argparse.ArgumentParser()
parser.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
DEVICE = config.resolve_device(parser.parse_args().device)

# %% [markdown]
# ## An SE2 odometry chain with a loop closure
#
# One anchored prior, noisy odometry, one loop closure. The further a pose
# is from the anchor (along the graph), the more uncertain it should be,
# and the loop closure pulls the uncertainty back down near the ends.

# %%
N, BATCH = 8, 1
rng = np.random.default_rng(0)
gt_t, cur = [], np.zeros((BATCH, 3))
for _ in range(N):
    gt_t.append(cur.copy())
    cur = cur + rng.normal(scale=0.5, size=(BATCH, 3)) * [1.0, 1.0, 0.4]
gt = [se2.exp(torch.as_tensor(t)) for t in gt_t]

obj = tt.Objective(dtype=torch.float64, device=DEVICE)
poses = [tt.SE2(tensor=se2.exp(torch.as_tensor(gt_t[i] + rng.normal(scale=0.2, size=(BATCH, 3)))), name=f"x{i}")
         for i in range(N)]
obj.add(tt.Difference(poses[0], tt.SE2(tensor=gt[0], name="anchor"), tt.ScaleCostWeight(100.0), name="prior"))
edges = [(i, i + 1) for i in range(N - 1)] + [(0, N - 1)]
for i, j in edges:
    meas = se2.compose(se2.inverse(gt[i]), gt[j])
    obj.add(tt.Between(poses[i], poses[j], tt.SE2(tensor=meas, name=f"m{i}_{j}"), tt.ScaleCostWeight(1.0),
                       name=f"e{i}_{j}"))

# %% [markdown]
# ## Solve with GBP
#
# `msg_iters` synchronous sweeps a relinearization; `msg_damping`
# stabilizes loopy graphs (0 = undamped, exact on trees).

# %%
gbp = tt.GaussianBeliefPropagation(obj, max_iterations=12, msg_iters=40, msg_damping=0.4)
out, info = gbp.optimize()
print("final 0.5*||r||^2:", float(info.last_err[0]))
assert float(info.last_err[0]) < 1e-8  # consistent measurements: an exact fit

# the same fixed point as Gauss-Newton
out_gn, _ = tt.GaussNewton(obj, max_iterations=12).optimize()
gap = max(float((out[f"x{i}"] - out_gn[f"x{i}"]).abs().max()) for i in range(N))
print(f"max |GBP - GN|: {gap:.2e}")
assert gap < 1e-4

# %% [markdown]
# ## Posterior marginals
#
# `marginals()` returns a `ManifoldGaussian` per variable: mean the
# solution, precision the belief information in the tangent plane at the
# mean. The translation standard deviation grows away from the anchor and
# is pulled down by the loop closure at the far end.

# %%
margs = gbp.marginals(values=out)
stds = []
for i in range(N):
    cov = np.linalg.inv(margs[f"x{i}"].precision[0].cpu().numpy())
    stds.append(float(np.sqrt(cov[1, 1] + cov[2, 2])))
print("translation std per pose:", " ".join(f"{s:.3f}" for s in stds))
assert stds[0] == min(stds), "the anchored pose is the most certain"
assert max(stds) == max(stds[1:]), "uncertainty grows away from the anchor"

# %% [markdown]
# The middle of the loop is the least certain: information reaches a pose
# along both directions of the cycle, so poses near the anchor (on either
# side, thanks to the 0 -> N-1 closure) are better constrained.

# %%
mid = int(np.argmax(stds))
assert 1 <= mid <= N - 1
print(f"least certain pose: x{mid}")
print("tutorial 06 OK")
