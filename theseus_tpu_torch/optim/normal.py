"""Dense and block-sparse normal-equation systems (JAX counterpart: theseus_tpu/optim/normal.py).

Each builder's `build` linearizes and returns a system that exposes what
the outer optimizers need: the damped solve, Atb, the quadratic form and
the AtA diagonal.

- `DenseNormalBuilder`: the dense A (B, M, D) of `dense_A_b`, AtA and Atb
  by two batched products under the full-float32 pin
  (`config.full_precision`), solved by optim/linear.py.
- `SparseNormalBuilder` owns the static symbolic state (block pattern,
  elimination ordering, level schedule, flatten tables) and assembles AtA
  blocks for the block Cholesky, or (solver="pcg") for the block-Jacobi
  PCG of sparse/pcg.py. `BlockNormal` / `BlockNormalBuilder` hold
  what the sparse and the Schur backend (optim/schur.py) share.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.compiled import CompiledObjective
from ..sparse.assemble import apply_block_damping, assemble, build_block_pattern
from ..sparse.cholesky import NumericSchedule, sparse_block_solve
from ..sparse.pcg import PCGSchedule, pcg_block_solve
from ..tracing import span
from .linear import DenseCholeskySolver, finite_or_zero
from .ordering import symbolic_for


class DenseNormal:
    """AtA (B, D, D) and Atb (B, D) with their solver."""

    def __init__(self, ata, atb, solver):
        self.AtA = ata
        self.Atb = atb
        self.solver = solver

    def solve(self, damping=0.0, ellipsoidal=False, rhs_shift=None):
        """Returns (delta (B, D), fail (B,)). rhs_shift (B, D), when given,
        is subtracted from Atb (the DLM backward's perturbed solves)."""
        rhs = self.Atb if rhs_shift is None else self.Atb - rhs_shift
        return self.solver.solve(self.AtA, rhs, damping, ellipsoidal)

    def quad(self, v):
        return torch.einsum("bi,bij,bj->b", v, self.AtA, v)

    def diag(self):
        return torch.diagonal(self.AtA, dim1=-2, dim2=-1)


class DenseNormalBuilder:
    def __init__(self, co: CompiledObjective, solver=None):
        self.co = co
        self.solver = solver or DenseCholeskySolver()

    def build(self, state, aux, detach_hessian: bool = False) -> DenseNormal:
        """detach_hessian: AtA carries no autograd history while Atb keeps
        its graph (the implicit backward's final Gauss-Newton step)."""
        with span("tt.linearize"):
            a, b = self.co.dense_A_b(state, aux)
        with span("tt.assemble"):
            a_h = a.detach() if detach_hessian else a
            with config.full_precision():
                ata = a_h.transpose(-1, -2) @ a_h
                atb = (a.transpose(-1, -2) @ b[..., None])[..., 0]
        return DenseNormal(ata, atb, self.solver)


class BlockNormal:
    """Assembled AtA blocks and Atb, with the quadratic form and diagonal
    the outer optimizers read."""

    def __init__(self, builder: "BlockNormalBuilder", ata, atb_blocks):
        self.builder = builder
        self.ata = ata  # (n_slots, B, d, d)
        self.atb_blocks = atb_blocks  # (n, B, d)
        self.Atb = builder.flatten(atb_blocks)  # (B, D)

    def quad(self, v):
        bld = self.builder
        vb = bld.unflatten(v)  # (n, B, d)
        ii, jj, slots, w = bld.quad_tables(v.device, v.dtype)
        terms = torch.einsum("sbi,sbij,sbj->sb", vb[ii], self.ata[slots], vb[jj])
        return torch.sum(terms * w[:, None], dim=0)

    def diag(self):
        bld = self.builder
        dblocks = self.ata[1 : bld.pattern.n_vars + 1]  # (n, B, d, d)
        return bld.flatten(torch.diagonal(dblocks, dim1=-2, dim2=-1))


class SparseNormal(BlockNormal):
    def solve(self, damping=0.0, ellipsoidal=False, rhs_shift=None):
        """Returns (delta (B, D), fail (B,)); see finite_or_zero. rhs_shift
        (B, D), when given, is subtracted from Atb (the DLM backward's
        perturbed solves)."""
        bld = self.builder
        ata = apply_block_damping(bld.pattern, self.ata, damping, ellipsoidal, bld.damping_eps)
        rhs = self.atb_blocks
        if rhs_shift is not None:
            rhs = rhs - bld.unflatten(rhs_shift)
        if bld.solver == "pcg":
            x = pcg_block_solve(bld.pcg_sched, ata, rhs, bld.pcg_iters, bld.pcg_tol)
        else:
            x = sparse_block_solve(bld.sched, ata, rhs)
        return finite_or_zero(bld.flatten(x))


class BlockNormalBuilder:
    """The static tables every block backend needs: the block pattern and
    the (n, B, d) <-> (B, total_dof) flatten tables."""

    normal_cls = BlockNormal

    def __init__(self, co: CompiledObjective, damping_eps: float = 1e-8):
        self.co = co
        self.damping_eps = damping_eps
        self.pattern = build_block_pattern(co)

        # flatten tables: (n, B, d) <-> (B, total_dof)
        d = self.pattern.d
        sel = []
        for i, dv in enumerate(self.pattern.var_dofs):
            sel.extend(range(i * d, i * d + int(dv)))
        self._sel = np.asarray(sel)
        self._n_total_pad = self.pattern.n_vars * d
        self.total_dof = len(sel)
        self._dev = {}

    def _on(self, device):
        key = str(device)
        if key not in self._dev:
            items = sorted(self.pattern.pair_slot.items(), key=lambda kv: kv[1])
            ii = np.array([k[0] for k, _ in items])
            jj = np.array([k[1] for k, _ in items])
            slots = np.array([s for _, s in items])
            as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
            self._dev[key] = {
                "sel": as_long(self._sel),
                "ii": as_long(ii),
                "jj": as_long(jj),
                "slots": as_long(slots),
                # off-diagonal blocks stand for two blocks of the full matrix
                "w": torch.as_tensor(np.where(ii == jj, 1.0, 2.0), device=device),
            }
        return self._dev[key]

    def quad_tables(self, device, dtype):
        t = self._on(device)
        return t["ii"], t["jj"], t["slots"], t["w"].to(dtype)

    def flatten(self, blocks):
        """(n, B, d) -> (B, total_dof)."""
        bsz = blocks.shape[1]
        flat = blocks.movedim(0, 1).reshape(bsz, self._n_total_pad)
        return flat[:, self._on(blocks.device)["sel"]]

    def unflatten(self, v):
        """(B, total_dof) -> (n, B, d) with zero padding."""
        bsz = v.shape[0]
        flat = torch.zeros((bsz, self._n_total_pad), dtype=v.dtype, device=v.device)
        flat[:, self._on(v.device)["sel"]] = v
        return flat.reshape(bsz, self.pattern.n_vars, self.pattern.d).movedim(1, 0)

    def build(self, state, aux, detach_hessian: bool = False) -> BlockNormal:
        """Linearize and assemble. detach_hessian: AtA carries no autograd
        history while Atb keeps its graph (the implicit backward's final
        Gauss-Newton step)."""
        with span("tt.linearize"):
            blocks = self.co.linearize_blocks(state, aux)
        with span("tt.assemble"):
            ata, atb = assemble(self.pattern, blocks)
        if detach_hessian:
            ata = ata.detach()
        return self.normal_cls(self, ata, atb)


class SparseNormalBuilder(BlockNormalBuilder):
    """Adds the solver's static state: for solver="direct" the elimination
    ordering and level schedule, for solver="pcg" the block-Jacobi PCG's
    matvec tables (no symbolic analysis; `sym` and `sched` are None)."""

    normal_cls = SparseNormal

    def __init__(self, co: CompiledObjective, ordering="auto", damping_eps: float = 1e-8,
                 solver: str = "direct", pcg_iters: int = 100, pcg_tol: float = 1e-10):
        super().__init__(co, damping_eps)
        if solver not in ("direct", "pcg"):
            raise ValueError("sparse_solver must be 'direct' or 'pcg'")
        self.solver = solver
        self.pcg_iters = pcg_iters
        self.pcg_tol = pcg_tol
        if solver == "pcg":
            self.sym = self.sched = None
            self.pcg_sched = PCGSchedule(self.pattern)
        else:
            self.sym = symbolic_for(self.pattern, ordering, co.var_names)
            self.sched = NumericSchedule(self.sym, self.pattern)
