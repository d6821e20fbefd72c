"""Schur-complement normal-equation backend for camera/landmark problems (JAX counterpart: theseus_tpu/optim/schur.py).

Bundle adjustment couples every landmark only to cameras, so the landmark
block of AtA is block diagonal and is eliminated in closed form:

    [Hcc  Hcp][xc]   [bc]        S = Hcc - Hcp Hpp^-1 Hpc
    [Hpc  Hpp][xp] = [bp]  =>    S xc = bc - Hcp Hpp^-1 bp
                                 xp = Hpp^-1 (bp - Hpc xc)

The landmark inverses are batched small Choleskys (ops/batched_linalg.py),
the reduced camera system S is one dense batched Cholesky. The block AtA
assembly (sparse/assemble.py and its CUDA kernel) and the damping are the
sparse backend's, so both backends damp and flatten identically.

Two ways to form S, chosen by `config.SCHUR_DENSE_BUDGET_BYTES`:
- dense W: W = Hcp Hpp^-1 and Hcp are scattered into (B, C*dc, P*dp)
  matrices and S, the reduced rhs and the landmark back-substitution are
  three batched products (torch.matmul, as the JAX package leaves them to
  XLA); the 128-camera x 4000-point problem takes this path;
- pairs: the pair products W_k H_l^T of each camera pair's shared points
  are summed into S by one `schur_pairs` launch (optim/schur_pairs.py,
  csrc/schur_pairs.cu; the JAX package scans padded point chunks), and
  the rhs products are segment sums.

Where PyTorch and JAX part ways, the port follows JAX's semantics:
- JAX's Cholesky symmetrizes its input and returns NaN for a matrix that is
  not positive definite; here S is symmetrized by hand and factored with
  `cholesky_ex` (no host sync), and a failed batch element's factor is set
  to NaN, so the `bad` mask zeroes its step and LM raises its damping;
- JAX's `.at[idx].add` accumulates repeated indices; here every such
  scatter is `index_add_` / `index_put_(accumulate=True)`.

A camera may be several variables: every camera-side variable that shares
a cost with a landmark is joined to the others of that cost into one
camera (BAL's 9-parameter camera: its SE3 pose and its (f, k1, k2)
intrinsics). S then has one block per camera, of the camera's summed dof
(6 + 3 = 9, not padded), and the pair sum runs over camera pairs, k^2 per
landmark seen by k cameras. A camera of one variable is that variable.
`pair_counts()` gives the pair sum's pairs, and the pairs a sum that pads
every point to the most cameras would form.

Spans (tracing.py): `tt.schur.eliminate` (the landmark Choleskys and W),
`tt.schur.reduce` (S), `tt.schur.factor` (its Cholesky), `tt.schur.backsub`
(each apply of the factors).

The solve is differentiable (`_SchurSolve`): its backward reuses the
forward's landmark Choleskys and reduced-camera factor for h = H^{-1} g,
as the sparse backend's solve reuses its factor. JAX gets the same
gradient by differentiating the plain ops of its solve.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import config
from ..core.compiled import CompiledObjective
from ..ops.batched_linalg import chol_small, chol_solve_mat, chol_solve_vec
from ..sparse.assemble import apply_block_damping
from ..sparse.refine import block_matvec, hp_dtype, refine, refine_active, solve_vjp
from ..tracing import span
from .normal import BlockNormal, BlockNormalBuilder, finite_or_zero
from .schur_pairs import pair_table, schur_pairs

# one-hot matmuls make segment sums fixed-order products; past this many
# one-hot elements the segment sum is a scatter-add instead
_ONEHOT_MAX_ELEMS = 1 << 22


def _seg_sum(values, idx, n_out: int):
    """Sum values (k, ...) into (n_out, ...) rows by idx (k,), a long
    tensor on values' device."""
    k = values.shape[0]
    if n_out * k <= _ONEHOT_MAX_ELEMS:
        onehot = torch.zeros((n_out, k), dtype=values.dtype, device=values.device)
        # a device-side one: a host scalar would be a copy that syncs
        onehot[idx, torch.arange(k, device=values.device)] = torch.ones((), dtype=values.dtype, device=values.device)
        return (onehot @ values.reshape(k, -1)).reshape((n_out,) + values.shape[1:])
    out = torch.zeros((n_out,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, idx, values)


def _cholesky(s):
    """Lower Cholesky of 0.5 (S + S^T), batched; NaN where S is not
    positive definite (JAX's convention), with no host sync."""
    l, info = torch.linalg.cholesky_ex(0.5 * (s + s.transpose(-1, -2)))
    return torch.where((info != 0)[:, None, None], torch.full_like(l, float("nan")), l)


class SchurNormal(BlockNormal):
    def solve(self, damping=0.0, ellipsoidal=False, rhs_shift=None):
        """Returns (delta (B, D), bad (B,)); a non-finite step (S not
        positive definite) is zeroed and flagged."""
        bld = self.builder
        ata = apply_block_damping(bld.pattern, self.ata, damping, ellipsoidal, bld.damping_eps)
        rhs = self.atb_blocks
        if rhs_shift is not None:
            rhs = rhs - bld.unflatten(rhs_shift)
        if config.needs_grad(ata, rhs):
            x_blocks = _SchurSolve.apply(self, ata, rhs)
        else:
            x_blocks = self._apply_refined(self._prepare_apply(ata), ata, rhs)
        return finite_or_zero(bld.flatten(x_blocks))

    def _apply_refined(self, apply_fn, ata, rhs):
        """apply_fn(rhs), then the iterative-refinement sweeps of the
        high-precision tier, each reusing the same factors."""
        x_blocks = apply_fn(rhs)
        if refine_active(rhs.dtype):
            tables = self.builder.pattern.matvec_tables(rhs.device)
            hp = hp_dtype(rhs.dtype)
            x_blocks = refine(apply_fn, lambda xv: block_matvec(tables, ata, xv, hp),
                              rhs, x_blocks, config.REFINE_STEPS)
        return x_blocks

    def _prepare_apply(self, ata):
        """Eliminate the landmarks and factor the reduced camera system;
        returns apply(rhs_blocks (n, B, d)) -> x_blocks (n, B, d).

        Landmark blocks run at the true point dof dp and camera blocks at
        the true camera dof dc (both <= the uniform pad d): padding dims
        carry identity diagonals and zero couplings, so the slices are
        exact. Each camera's dc rows are gathered from its variables'
        (`cam_blocks`, `cam_cc`, `cam_rhs`)."""
        bld = self.builder
        t = bld.tables(ata.device)
        bsz, dtype = ata.shape[1], ata.dtype
        C, P, dc, dp = bld.n_cams, len(bld.pt_vars), bld.cam_d, bld.pt_d

        with span("tt.schur.eliminate"):
            hpp = ata[t["pt_diag_slots"]][..., :dp, :dp]  # (P, B, dp, dp)
            lpp = chol_small(0.5 * (hpp + hpp.transpose(-1, -2)))

            # camera-point blocks oriented (camera rows, point cols)
            hcp = ata[t["cp_slots"]]  # (O, B, d, d)
            hcp = torch.where(t["cp_tr"][:, None, None, None], hcp.transpose(-1, -2), hcp)
            hcp = bld.cam_blocks(hcp[..., :dp], t)
            # W_o = Hcp_o Hpp_{p(o)}^-1
            w = chol_solve_mat(lpp[t["cp_pt"]], hcp.transpose(-1, -2)).transpose(-1, -2)

        def s_matrix(h):  # (C, C, B, dc, dc) -> (B, C*dc, C*dc)
            return h.permute(2, 0, 3, 1, 4).reshape(bsz, C * dc, C * dc)

        def split(rhs):
            return rhs[t["pt_vars"]][..., :dp], bld.cam_rhs(rhs, t)

        with span("tt.schur.reduce"):
            hcc = bld.cam_cc(ata, t)  # dense, (C, C, B, dc, dc)
            dense = bld.use_dense_elimination(bsz, dtype)
            if dense:
                w2, h2 = bld.densify(w, t), bld.densify(hcp, t)  # (B, C*dc, P*dp)
                s_mat = s_matrix(hcc) - w2 @ h2.transpose(1, 2)
            else:
                # S -= sum over points of W_k H_l^T for the camera pairs
                # (k, l) of each point, in place in a fresh S
                s_mat = schur_pairs(s_matrix(hcc).contiguous(), w, hcp, bld.pair_table(ata.device))
        with span("tt.schur.factor"):
            ls = _cholesky(s_mat)

        if dense:
            def apply_fn(rhs):
                with span("tt.schur.backsub"):
                    bp, bc = split(rhs)
                    bp_flat = bp.movedim(0, 1).reshape(bsz, P * dp)
                    rc = bc.movedim(0, 1).reshape(bsz, C * dc) - (w2 @ bp_flat[..., None])[..., 0]
                    xc_flat = torch.cholesky_solve(rc[..., None], ls)[..., 0]
                    hx = (h2.transpose(1, 2) @ xc_flat[..., None])[..., 0]  # (B, P*dp)
                    xp = chol_solve_vec(lpp, bp - hx.reshape(bsz, P, dp).movedim(1, 0))
                    return bld.scatter_x(xc_flat.reshape(bsz, C, dc).movedim(1, 0), xp)

            return apply_fn

        def apply_fn(rhs):
            with span("tt.schur.backsub"):
                bp, bc = split(rhs)
                wb = torch.einsum("obij,obj->obi", w, bp[t["cp_pt"]])  # (O, B, dc)
                rc = (bc - _seg_sum(wb, t["cp_cam"], C)).movedim(0, 1).reshape(bsz, C * dc)
                xc_flat = torch.cholesky_solve(rc[..., None], ls)[..., 0]
                xc = xc_flat.reshape(bsz, C, dc).movedim(1, 0)  # (C, B, dc)
                hx = torch.einsum("obji,obj->obi", hcp, xc[t["cp_cam"]])  # (O, B, dp)
                xp = chol_solve_vec(lpp, bp - _seg_sum(hx, t["cp_pt"], P))
                return bld.scatter_x(xc, xp)

        return apply_fn


class _SchurSolve(torch.autograd.Function):
    """x = H^{-1} rhs through the Schur elimination, with factor reuse.

    Forward: eliminate and factor once (`_prepare_apply`), apply, refine.
    Backward: `solve_vjp`, as the sparse solve's, its h = H^{-1} g by the
    same apply and refinement; d_ata only when asked for."""

    @staticmethod
    def forward(ctx, normal, ata, rhs):
        apply_fn = normal._prepare_apply(ata)
        x = normal._apply_refined(apply_fn, ata, rhs)
        ctx.normal, ctx.apply_fn = normal, apply_fn
        ctx.save_for_backward(ata, x)
        return x

    @staticmethod
    def backward(ctx, g):
        ata, x = ctx.saved_tensors
        d_ata, h = solve_vjp(lambda r: ctx.normal._apply_refined(ctx.apply_fn, ata, r),
                             ctx.normal.builder.pattern.matvec_tables(g.device), ata, x, g,
                             ctx.needs_input_grad[1])
        return None, d_ata, h


def camera_groups(co: CompiledObjective, elim: np.ndarray):
    """The cameras of a Schur build: lists of camera-side variable indices,
    each list the variables joined by costs that also touch an eliminated
    variable (a Reprojection's pose and intrinsics), ordered by their first
    variable; a camera-side variable in no such cost is a camera alone."""
    n = len(co.var_names)
    dofs = np.asarray([co.var_groups[nm].dof for nm in co.var_names], np.int64)
    col2var = np.repeat(np.arange(n, dtype=np.int64), dofs)
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for bk in co.buckets:
        gv = [col2var[np.asarray(s.cols)[:, 0]] for s in bk.optim_slots]
        if len(gv) < 3:
            continue
        gv = np.broadcast_arrays(*gv)
        touches = np.zeros(len(gv[0]), bool)
        for v in gv:
            touches |= elim[v]
        for a in range(len(gv)):
            for b in range(a + 1, len(gv)):
                rows = touches & ~elim[gv[a]] & ~elim[gv[b]] & (gv[a] != gv[b])
                for i, j in np.unique(np.stack([gv[a][rows], gv[b][rows]], 1), axis=0):
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[max(ri, rj)] = min(ri, rj)
    cams = np.flatnonzero(~elim)
    roots = np.asarray([find(v) for v in cams], np.int64)
    return [cams[roots == r] for r in np.unique(roots)]


class SchurNormalBuilder(BlockNormalBuilder):
    """eliminate: predicate(name, group) -> True for landmark-style vars."""

    normal_cls = SchurNormal

    def __init__(self, co: CompiledObjective, eliminate, damping_eps: float = 1e-8):
        super().__init__(co, damping_eps)
        pattern = self.pattern
        n = pattern.n_vars
        elim = np.asarray([bool(eliminate(nm, co.var_groups[nm])) for nm in co.var_names])
        self.elim = elim
        self.cam_vars = np.flatnonzero(~elim)
        self.pt_vars = np.flatnonzero(elim)
        if not len(self.pt_vars):
            raise ValueError("Schur backend: nothing to eliminate.")
        dofs = pattern.var_dofs.astype(np.int64)
        # the cameras (camera_groups): a camera's rows are its variables'
        # dofs one after the other, in variable order
        groups = camera_groups(co, elim)
        self.n_cams = len(groups)
        cam_index = np.full(n, -1, np.int64)  # the camera of each camera-side variable
        cam_off = np.zeros(n, np.int64)  # its first row in the camera
        for c, g in enumerate(groups):
            cam_index[g] = c
            cam_off[g] = np.cumsum(dofs[g]) - dofs[g]
        # true max dofs per side: the elimination runs on (dc, dp) slices
        self.pt_d = int(dofs[self.pt_vars].max())
        self.cam_d = max(int(dofs[g].sum()) for g in groups) if groups else pattern.d
        pt_index = np.full(n, -1, np.int64)
        pt_index[self.pt_vars] = np.arange(len(self.pt_vars))

        # off-diagonal slots in pattern order, split into camera-camera and
        # camera-point couplings; stored blocks have rows = min(i, j)
        off = [(i, j, s) for (i, j), s in pattern.pair_slot.items() if i != j]
        ij = np.asarray([(i, j) for i, j, _ in off], np.int64).reshape(-1, 2)
        slots = np.asarray([s for _, _, s in off], np.int64)
        ei, ej = elim[ij[:, 0]], elim[ij[:, 1]]
        both = np.flatnonzero(ei & ej)
        if len(both):
            i, j = ij[both[0]]
            raise ValueError(
                "Schur backend requires no costs coupling two eliminated "
                f"variables (found pair {co.var_names[i]}, {co.var_names[j]})."
            )
        is_cc = ~ei & ~ej
        is_cp = ei ^ ej
        cam_diag = np.asarray([pattern.pair_slot[(v, v)] for v in self.cam_vars], np.int64)
        self.cc_slots = np.concatenate([slots[is_cc], cam_diag])
        cc_vi = np.concatenate([ij[is_cc, 0], self.cam_vars])
        cc_vj = np.concatenate([ij[is_cc, 1], self.cam_vars])
        cam = np.where(ej, ij[:, 0], ij[:, 1])[is_cp]
        pt = np.where(ej, ij[:, 1], ij[:, 0])[is_cp]
        self.cp_slots = slots[is_cp]
        self.cp_tr = cam > pt  # the stored block has the point's rows

        # the (camera, point) couplings the elimination runs on, one per
        # pair, in order of first appearance among the variables' couplings
        key = cam_index[cam] * len(self.pt_vars) + pt_index[pt]
        _, first, inv = np.unique(key, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        self.cp_cam, self.cp_pt = cam_index[cam[first[order]]], pt_index[pt[first[order]]]
        # each coupling's dc rows from its variables' couplings (g_*)
        dc, og, dv = self.cam_d, rank[inv.reshape(-1)], dofs[cam]
        e_rep = np.repeat(np.arange(len(cam)), dv)
        r_rep = np.arange(int(dv.sum())) - np.repeat(np.cumsum(dv) - dv, dv)
        at = og[e_rep] * dc + cam_off[cam][e_rep] + r_rep
        self.g_src_e = np.zeros(len(order) * dc, np.int64)
        self.g_src_r = np.zeros(len(order) * dc, np.int64)
        self.g_valid = np.zeros(len(order) * dc, bool)
        self.g_src_e[at], self.g_src_r[at], self.g_valid[at] = e_rep, r_rep, True
        # Hcc element by element: block (vi, vj) at its cameras' rows, and
        # its transpose for two variables
        el = []
        for s, (vi, vj) in enumerate(zip(cc_vi, cc_vj)):
            ri, rj = cam_index[vi] * dc + cam_off[vi], cam_index[vj] * dc + cam_off[vj]
            for r in range(dofs[vi]):
                for c in range(dofs[vj]):
                    el.append((s, r, c, ri + r, rj + c))
                    if vi != vj:
                        el.append((s, r, c, rj + c, ri + r))
        self.cc_el = np.asarray(el, np.int64).reshape(-1, 5)
        # a camera's rows past its dofs: identity on S's diagonal, zero rhs
        cdof = np.bincount(cam_index[self.cam_vars], weights=dofs[self.cam_vars], minlength=self.n_cams)
        self.cam_pad = np.flatnonzero(np.arange(dc)[None, :] >= cdof.astype(np.int64)[:, None])
        # each camera row's row of the (n * d) right-hand side, -1 past its dofs
        d = pattern.d
        self.rhs_rows = np.full(self.n_cams * dc, -1, np.int64)
        for v in self.cam_vars:
            base = cam_index[v] * dc + cam_off[v]
            self.rhs_rows[base:base + dofs[v]] = v * d + np.arange(dofs[v])
        self.pt_diag_slots = np.asarray([pattern.pair_slot[(v, v)] for v in self.pt_vars], np.int64)
        self._tables: Dict[str, Dict[str, torch.Tensor]] = {}
        self._pairs: Dict[str, Dict[str, torch.Tensor]] = {}

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """The index tables as tensors on `device`, built once: a copy from
        the host inside the solver loop would synchronize the stream."""
        key = str(device)
        if key not in self._tables:
            long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
            C, dc, el = self.n_cams, self.cam_d, self.cc_el
            self._tables[key] = {
                "pt_diag_slots": long(self.pt_diag_slots),
                "cp_slots": long(self.cp_slots),
                "cp_tr": torch.as_tensor(self.cp_tr, dtype=torch.bool, device=device),
                "cp_cam": long(self.cp_cam),
                "cp_pt": long(self.cp_pt),
                "cc_slots": long(self.cc_slots),
                "pt_vars": long(self.pt_vars),
                "g_src_e": long(self.g_src_e.reshape(-1, dc)),
                "g_src_r": long(self.g_src_r.reshape(-1, dc)),
                "g_valid": torch.as_tensor(self.g_valid.reshape(-1, dc), device=device),
                "cc_el_src": long(el[:, 0]), "cc_el_r": long(el[:, 1]), "cc_el_c": long(el[:, 2]),
                "cc_el_row": long(el[:, 3]), "cc_el_col": long(el[:, 4]),
                "cam_pad": long(self.cam_pad),
                "rhs_rows": long(np.maximum(self.rhs_rows, 0).reshape(C, dc)),
                "rhs_valid": torch.as_tensor((self.rhs_rows >= 0).reshape(C, dc), device=device),
                # scatter_x: each camera dof's row of x and its place in (C dc)
                "sx_dst": long(self.rhs_rows[self.rhs_rows >= 0]),
                "sx_src": long(np.flatnonzero(self.rhs_rows >= 0)),
            }
        return self._tables[key]

    def cam_blocks(self, hcp_var, t):
        """(O_var, B, d, dp) blocks of each variable's coupling with a point
        -> (O, B, dc, dp), each camera's coupling in its dc rows."""
        g = hcp_var[t["g_src_e"], :, t["g_src_r"]]  # (O, dc, B, dp)
        return torch.where(t["g_valid"][:, :, None, None], g, 0.0).movedim(1, 2)

    def cam_cc(self, ata, t):
        """Hcc as (C, C, B, dc, dc) from the camera-side blocks of ata, the
        rows past a camera's dofs an identity."""
        C, dc, bsz = self.n_cams, self.cam_d, ata.shape[1]
        vals = ata[t["cc_slots"]][t["cc_el_src"], :, t["cc_el_r"], t["cc_el_c"]]  # (N, B)
        h = torch.zeros((C * dc, C * dc, bsz), dtype=ata.dtype, device=ata.device)
        h.index_put_((t["cc_el_row"], t["cc_el_col"]), vals, accumulate=True)
        pad = t["cam_pad"]
        if pad.numel():  # a device-side one: a host scalar would be a copy that syncs
            h.index_put_((pad, pad), torch.ones((), dtype=h.dtype, device=h.device))
        return h.reshape(C, dc, C, dc, bsz).permute(0, 2, 4, 1, 3)

    def cam_rhs(self, rhs, t):
        """(n, B, d) -> the cameras' (C, B, dc), zero past their dofs."""
        flat = rhs.movedim(1, 2).reshape(-1, rhs.shape[1])  # (n * d, B)
        return torch.where(t["rhs_valid"][..., None], flat[t["rhs_rows"]], 0.0).movedim(1, 2)

    def pair_counts(self):
        """(useful, padded): the camera-pair products of the pair sum, sum
        over points of k^2 for a point seen by k cameras, and P K^2 with
        every point padded to the largest k, K."""
        k = np.bincount(self.cp_pt, minlength=len(self.pt_vars)).astype(np.int64)
        return int(np.sum(k * k)), int(len(self.pt_vars) * max(1, int(k.max()) if len(k) else 1) ** 2)

    def use_dense_elimination(self, bsz: int, dtype: torch.dtype) -> bool:
        """True when the densified W and Hcp (B, C*dc, P*dp), plus one
        product transient of the same size, fit the configured budget."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        size = bsz * (self.n_cams * self.cam_d) * (len(self.pt_vars) * self.pt_d)
        return 3 * size * itemsize <= config.SCHUR_DENSE_BUDGET_BYTES

    def densify(self, blocks, t):
        """(O, B, dc, dp) coupling blocks -> (B, C*dc, P*dp) dense matrix."""
        C, P = self.n_cams, len(self.pt_vars)
        bsz, dc, dp = blocks.shape[1:]
        dd = torch.zeros((C, P, bsz, dc, dp), dtype=blocks.dtype, device=blocks.device)
        dd[t["cp_cam"], t["cp_pt"]] = blocks  # each (camera, point) pair once
        return dd.permute(2, 0, 3, 1, 4).reshape(bsz, C * dc, P * dp)

    def pair_table(self, device) -> Dict[str, torch.Tensor]:
        """`schur_pairs.pair_table` of the couplings as int32 tensors on
        `device`, built once (a Dubrovnik-356-sized table holds 10.6e6
        entries, ~85 MB)."""
        key = str(device)
        if key not in self._pairs:
            self._pairs[key] = {k: torch.as_tensor(v, device=device)
                                for k, v in pair_table(self.cp_cam, self.cp_pt, self.n_cams).items()}
        return self._pairs[key]

    def scatter_x(self, xc, xp):
        """(C, B, dc) camera and (P, B, dp) landmark steps -> (n, B, d)."""
        d, n = self.pattern.d, self.pattern.n_vars
        t = self.tables(xc.device)
        x = torch.zeros((n * d, xc.shape[1]), dtype=xc.dtype, device=xc.device)
        # long indices made on the host: a boolean mask would sync
        x[t["sx_dst"]] = xc.movedim(1, 2).reshape(-1, xc.shape[1])[t["sx_src"]]
        x = x.reshape(n, d, -1).movedim(1, 2).contiguous()
        x[t["pt_vars"]] = torch.nn.functional.pad(xp, (0, d - xp.shape[-1]))
        return x


def eliminate_points(name: str, group) -> bool:
    """Default predicate: eliminate every Euclidean (Rn) variable."""
    return group.name.startswith("Rn")
