"""The SE3 pose graph of sphere2500's size: its generator, the program's
build and calls, and the comparison with the plain reference.

The graph (the configuration's "layout") is a rows x cols grid of poses
numbered along the chain that snakes through it (a robot's back-and-forth
sweep): the chain's edges are the odometry, every vertical edge the chain
does not take is a loop closure, and a Local prior holds pose 0. Ground truth exp(N(0, gt_spread^2)),
measurements gt_i^-1 gt_j exp(N(0, measurement^2)) and initial poses
gt exp(N(0, init^2)) are drawn on the device from the seed, each batch
element its own graph; the program and the reference get the same float32
values.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import lie, lm, pgo, precision


def grid_edges(rows: int, cols: int):
    """(edges [(i, j)], loop_mask (E,) bool): odometry first, then closures."""
    def at(i, j):
        return i * cols + (j if i % 2 == 0 else cols - 1 - j)

    n = rows * cols
    vertical = [(min(at(i, j), at(i + 1, j)), max(at(i, j), at(i + 1, j)))
                for i in range(rows - 1) for j in range(cols)]
    edges = [(k, k + 1) for k in range(n - 1)] + [e for e in vertical if e[1] - e[0] > 1]
    return edges, np.arange(len(edges)) >= n - 1


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float64, device=device)


class Problem:
    """One run's data and the program built on it.

    cfg: the configuration file; traffic: the traffic file; the program is
    built in cfg["dtype"] on `device`."""

    BATCH_AXIS = 0  # of each pose's value (B, 3, 4) the program takes

    def __init__(self, cfg, traffic, seed: int, device, train: bool = False):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg["dtype"])
        self.train = train
        layout, b = cfg["layout"], traffic["batch"]
        if layout["kind"] != "snake_grid":
            raise ValueError(f"no generator for the layout {layout['kind']!r}")
        self.n = layout["rows"] * layout["cols"]
        edges, loop = grid_edges(layout["rows"], layout["cols"])
        if (self.n, len(edges)) != (cfg["n_poses"], cfg["n_edges"]):
            raise ValueError(f"the layout gives {self.n} poses and {len(edges)} edges, the configuration "
                             f"states {cfg['n_poses']} and {cfg['n_edges']}")
        self.edges = edges
        self.loop_mask = torch.as_tensor(loop, device=self.device)
        noise = cfg["noise"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        e = torch.as_tensor(edges, device=self.device)
        gt = lie.exp(noise["gt_spread"] * _normal(gen, (self.n, b, 6), self.device))
        rel = lie.compose(lie.inverse(gt[e[:, 0]]), gt[e[:, 1]])
        meas = lie.compose(rel, lie.exp(noise["measurement"] * _normal(gen, (len(edges), b, 6), self.device)))
        inits = [lie.compose(gt, lie.exp(noise["init"] * _normal(gen, (self.n, b, 6), self.device)))
                 for _ in range(traffic["pool"])]
        # the inputs both sides get: the configuration's dtype
        self.gt = gt.to(self.dtype)
        self.meas = meas.to(self.dtype)
        self.pool = [x.to(self.dtype) for x in inits]
        self.edge_tensor = e
        self._build_program()

    # -- the program ----------------------------------------------------
    def _build_program(self):
        import theseus_tpu_torch as tt
        from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, training_weights

        # the program runs in the precision the configuration states
        tf32 = bool(self.cfg["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        solver = self.cfg["solver"]
        kw = {}
        if self.train:
            kw = dict(zip(("edge_weight", "loop_weight"), training_weights()))
        obj, _ = build_pgo_objective(self.n, self.edges, self.meas, self.gt[0], dtype=self.dtype,
                                     device=self.device, prior_weight=self.cfg["prior_weight"], **kw)
        opt = tt.LevenbergMarquardt(
            obj, max_iterations=solver["max_iterations"], linearization=solver["linearization"],
            adaptive_damping=solver["adaptive_damping"], ellipsoidal_damping=solver["ellipsoidal"],
            damping=solver["damping"])
        self.layer = tt.TheseusLayer(opt)
        self.names = [f"pose_{i}" for i in range(self.n)]
        if self.train:
            tcfg = self.cfg["train"]
            self.theta = torch.tensor(float(tcfg["theta0"]), dtype=self.dtype, device=self.device,
                                      requires_grad=True)
            self.sgd = torch.optim.SGD([self.theta], lr=float(tcfg["lr"]))

    def inputs(self, i):
        """The program's inputs of call i: pool draw i's initial poses."""
        x = self.pool[i % len(self.pool)]
        return {name: x[k] for k, name in enumerate(self.names)}

    def solve(self, i):
        """One timed call: a forward solve of pool draw i. Returns the
        output values and the solver's info."""
        with torch.no_grad():
            return self.layer.forward(self.inputs(i))

    def answer(self, out):
        """The kept answer of a call: the poses (N, B, 3, 4)."""
        return torch.stack([out[name] for name in self.names]).detach().clone()

    def train_step(self, i, mark=None):
        """One timed training step on pool draw i: forward through the layer
        with the configured backward mode, the outer loss, backward() and
        the SGD step. mark(), when given, is called between the loss and
        backward(). Returns the loss (detached) and the forward's values."""
        tcfg = self.cfg["train"]
        inputs = self.inputs(i)
        inputs["w_loop"] = self.theta.reshape(1, 1)
        out, _ = self.layer.forward(inputs, optimizer_kwargs={"backward_mode": tcfg["backward_mode"]})
        loss = self.loss(out)
        if mark is not None:
            mark()
        self.sgd.zero_grad(set_to_none=True)
        loss.backward()
        self.sgd.step()
        return loss.detach(), out

    def loss(self, out):
        """The outer loss: the program's `mean_sq_local` against the truth."""
        from theseus_tpu_torch.utils.examples.pose_graph import mean_sq_local

        return mean_sq_local(out, self.gt)

    def parameter(self):
        return self.theta.detach().clone()

    def free_program(self):
        for name in ("layer", "theta", "sgd"):
            self.__dict__.pop(name, None)

    # -- what the per-layer metrics count -----------------------------------
    def shapes(self):
        return {"d": 6, "batch": self.traffic["batch"], "n_vars": self.n, "pairs": self.edges,
                "between": len(self.edges), "local": 1,
                "iterations": self.cfg["solver"]["max_iterations"]}

    # -- the reference ------------------------------------------------------
    def _graph(self, dtype, theta=None, store=None):
        w = torch.ones(len(self.edges), dtype=dtype, device=self.device)
        if theta is not None:
            w = torch.where(self.loop_mask, torch.as_tensor(theta, dtype=dtype, device=self.device), w)
        return pgo.PoseGraph(self.n, self.edge_tensor, self.meas.to(dtype), self.gt[0].to(dtype), w,
                             self.cfg["prior_weight"], store)

    def reference_solve(self, i, prec="float64"):
        """The reference's solve of call i's inputs in precision `prec`
        (reference/precision.py)."""
        dtype, store = precision.dtypes(prec)
        graph = self._graph(dtype, store=store)
        opts = lm.options(self.cfg["solver"])
        with precision.products(prec):
            x, _ = pgo.solve(graph, self.pool[i % len(self.pool)].to(dtype), self.cfg["solver"]["max_iterations"],
                             opts)
        return x

    @staticmethod
    def cost_gaps(graph, x, ref):
        """(B,): each batch element's (f(x) - f(ref)) / f(ref), f the
        objective in float64; a value that is not a number reads infinite."""
        f_ref = graph.cost(ref.to(torch.float64))
        gap = (graph.cost(x.to(torch.float64)) - f_ref) / f_ref
        return torch.nan_to_num(gap, nan=float("inf"))

    def judge_solve(self, samples, prec="float64", detail=False):
        """samples: [(call index, poses (N, B, 3, 4))]. Returns {"cost_gap":
        the largest, over the samples, of the mean over the batch of
        |cost_gaps|}; with `detail`, also the signed mean and the largest
        element of cost_gaps."""
        graph = self._graph(torch.float64)
        gaps = torch.cat([self.cost_gaps(graph, x, self.reference_solve(i, prec)) for i, x in samples])
        out = {"cost_gap": max(float(g.abs().mean()) for g in gaps.split(self.traffic["batch"]))}
        if detail:
            out.update(cost_gap_signed=float(gaps.mean()), cost_gap_max=float(gaps.max()))
        return out

    def reference_train(self, steps: int, prec="float64"):
        """The reference's own first `steps` steps from theta0 in precision
        `prec`: [(loss, theta after the step)], and the first step's poses
        after its final Gauss-Newton step."""
        tcfg, solver = self.cfg["train"], self.cfg["solver"]
        theta, lr, out, first = float(tcfg["theta0"]), float(tcfg["lr"]), [], None
        opts = lm.options(solver)
        dtype, store = precision.dtypes(prec)
        with precision.products(prec):
            for i in range(steps):
                graph = self._graph(dtype, theta, store)
                x, _ = pgo.solve(graph, self.pool[i % len(self.pool)].to(dtype), solver["max_iterations"], opts)
                loss, grad, x_final = pgo.implicit_loss_and_grad(graph, x, self.gt.to(dtype), self.loop_mask,
                                                                 theta)
                first = x_final if first is None else first
                theta = theta - lr * grad
                out.append((loss, theta))
        return out, first

    def judge_train(self, history, first, prec="float64", detail=False):
        """history: the program's first steps [(loss, theta after the
        step)]; first: the poses its first forward returned. Returns the
        relative gaps of each step's loss (the worst), of the first gradient
        (from theta's first move) and of theta's change over the steps, and
        the first forward's cost gap (the mean over the batch of
        |cost_gaps|; with `detail`, also their signed mean and largest)."""
        ref, ref_first = self.reference_train(len(history), prec)
        theta0, lr = float(self.cfg["train"]["theta0"]), float(self.cfg["train"]["lr"])
        loss_gap = max(abs(p[0] - r[0]) / abs(r[0]) for p, r in zip(history, ref))
        g_p, g_r = (theta0 - history[0][1]) / lr, (theta0 - ref[0][1]) / lr
        c_p, c_r = history[-1][1] - theta0, ref[-1][1] - theta0
        gaps = self.cost_gaps(self._graph(torch.float64, theta0), first, ref_first)
        out = {"loss_gap": loss_gap, "grad_gap": abs(g_p - g_r) / abs(g_r), "change_gap": abs(c_p - c_r) / abs(c_r),
               "cost_gap": float(gaps.abs().mean())}
        if detail:
            out.update(cost_gap_signed=float(gaps.mean()), cost_gap_max=float(gaps.max()))
        return out
