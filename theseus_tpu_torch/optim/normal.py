"""Block-sparse normal-equation system (JAX counterpart: theseus_tpu/optim/normal.py).

`SparseNormalBuilder` owns the static symbolic state (block pattern,
elimination ordering, level schedule, flatten tables); `build` linearizes,
assembles AtA / Atb and returns a `SparseNormal`, which exposes what the
outer optimizers need: the damped solve, Atb, the quadratic form and the
AtA diagonal. The dense and Schur backends are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.compiled import CompiledObjective
from ..sparse.assemble import apply_block_damping, assemble, build_block_pattern
from ..sparse.cholesky import NumericSchedule, sparse_block_solve
from .ordering import symbolic_for


class SparseNormal:
    def __init__(self, builder: "SparseNormalBuilder", ata, atb_blocks):
        self.builder = builder
        self.ata = ata  # (n_slots, B, d, d)
        self.atb_blocks = atb_blocks  # (n, B, d)
        self.Atb = builder.flatten(atb_blocks)  # (B, D)

    def solve(self, damping=0.0, ellipsoidal=False):
        """Returns (delta (B, D), fail (B,)): a batch element whose solve
        came out non-finite (e.g. a non-positive pivot) gets a zero delta
        and fail=True."""
        bld = self.builder
        ata = apply_block_damping(bld.pattern, self.ata, damping, ellipsoidal, bld.damping_eps)
        x = sparse_block_solve(bld.sched, ata, self.atb_blocks)
        delta = bld.flatten(x)
        bad = torch.any(~torch.isfinite(delta), dim=-1)
        delta = torch.where(bad[..., None], torch.zeros_like(delta), delta)
        return delta, bad

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


class SparseNormalBuilder:
    """Owns the static symbolic state (pattern, schedule, flatten tables)."""

    def __init__(self, co: CompiledObjective, ordering="auto", damping_eps: float = 1e-8):
        self.co = co
        self.damping_eps = damping_eps
        self.pattern = build_block_pattern(co)
        self.sym = symbolic_for(self.pattern, ordering, co.var_names)
        self.sched = NumericSchedule(self.sym, self.pattern)

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

    def build(self, state, aux) -> SparseNormal:
        blocks = self.co.linearize_blocks(state, aux)
        ata, atb = assemble(self.pattern, blocks)
        return SparseNormal(self, ata, atb)
