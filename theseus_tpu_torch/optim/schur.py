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
- chunked: the per-point pair products W_k H_l^T are summed into S over
  fixed-size point chunks (a Python loop where the JAX package scans), and
  the rhs products are segment sums.

Where PyTorch and JAX part ways, the port follows JAX's semantics:
- JAX's Cholesky symmetrizes its input and returns NaN for a matrix that is
  not positive definite; here S is symmetrized by hand and factored with
  `cholesky_ex` (no host sync), and a failed batch element's factor is set
  to NaN, so the `bad` mask zeroes its step and LM raises its damping;
- JAX's `.at[idx].add` accumulates repeated indices; here every such
  scatter is `index_add_` / `index_put_(accumulate=True)`.

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
from .normal import BlockNormal, BlockNormalBuilder, finite_or_zero

# one-hot matmuls make segment sums fixed-order products; past this many
# one-hot elements the segment sum is a scatter-add instead
_ONEHOT_MAX_ELEMS = 1 << 22
# bytes of the (Pc, K, K, B, dc, dc) pair tensor of one point chunk
_CHUNK_BYTES = 256 << 20


def _seg_sum(values, idx, n_out: int):
    """Sum values (k, ...) into (n_out, ...) rows by idx (k,), a long
    tensor on values' device."""
    k = values.shape[0]
    if n_out * k <= _ONEHOT_MAX_ELEMS:
        onehot = torch.zeros((n_out, k), dtype=values.dtype, device=values.device)
        onehot[idx, torch.arange(k, device=values.device)] = 1.0
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
        exact."""
        bld = self.builder
        t = bld.tables(ata.device)
        bsz, dtype = ata.shape[1], ata.dtype
        C, P, dc, dp = len(bld.cam_vars), len(bld.pt_vars), bld.cam_d, bld.pt_d

        hpp = ata[t["pt_diag_slots"]][..., :dp, :dp]  # (P, B, dp, dp)
        lpp = chol_small(0.5 * (hpp + hpp.transpose(-1, -2)))

        # camera-point blocks oriented (camera rows, point cols)
        hcp = ata[t["cp_slots"]]  # (O, B, d, d)
        hcp = torch.where(t["cp_tr"][:, None, None, None], hcp.transpose(-1, -2), hcp)
        hcp = hcp[..., :dc, :dp]
        # W_o = Hcp_o Hpp_{p(o)}^-1
        w = chol_solve_mat(lpp[t["cp_pt"]], hcp.transpose(-1, -2)).transpose(-1, -2)

        # dense Hcc as (C, C, B, dc, dc); camera-camera slots are stored
        # with rows = the lower camera index, which is the (i, j) orientation
        cc = ata[t["cc_slots"]][..., :dc, :dc]
        hcc = torch.zeros((C, C, bsz, dc, dc), dtype=dtype, device=ata.device)
        hcc.index_put_((t["cc_i"], t["cc_j"]), cc, accumulate=True)
        hcc.index_put_((t["cc_j_off"], t["cc_i_off"]), cc[t["cc_off"]].transpose(-1, -2),
                       accumulate=True)

        def s_matrix(h):  # (C, C, B, dc, dc) -> (B, C*dc, C*dc)
            return h.permute(2, 0, 3, 1, 4).reshape(bsz, C * dc, C * dc)

        def split(rhs):
            return rhs[t["pt_vars"]][..., :dp], rhs[t["cam_vars"]][..., :dc]

        if bld.use_dense_elimination(bsz, dtype):
            w2, h2 = bld.densify(w, t), bld.densify(hcp, t)  # (B, C*dc, P*dp)
            ls = _cholesky(s_matrix(hcc) - w2 @ h2.transpose(1, 2))

            def apply_fn(rhs):
                bp, bc = split(rhs)
                bp_flat = bp.movedim(0, 1).reshape(bsz, P * dp)
                rc = bc.movedim(0, 1).reshape(bsz, C * dc) - (w2 @ bp_flat[..., None])[..., 0]
                xc_flat = torch.cholesky_solve(rc[..., None], ls)[..., 0]
                hx = (h2.transpose(1, 2) @ xc_flat[..., None])[..., 0]  # (B, P*dp)
                xp = chol_solve_vec(lpp, bp - hx.reshape(bsz, P, dp).movedim(1, 0))
                return bld.scatter_x(xc_flat.reshape(bsz, C, dc).movedim(1, 0), xp)

            return apply_fn

        # chunked: S -= sum over points of W_k H_l^T for the camera pairs
        # (k, l) of each point, accumulated chunk by chunk into (C*C+1)
        # pair blocks (the last one catches the padding)
        obs_x, val_x, pair_x = bld.chunk_tables(ata.device, bsz, dc)
        s_acc = torch.zeros((C * C + 1, bsz, dc, dc), dtype=dtype, device=ata.device)
        for obs_c, val_c, pair_c in zip(obs_x, val_x, pair_x):
            vmask = val_c[:, :, None, None, None]
            wg = torch.where(vmask, w[obs_c], 0.0)  # (Pc, K, B, dc, dp)
            hg = torch.where(vmask, hcp[obs_c], 0.0)
            pair_s = torch.einsum("pkbij,plbmj->pklbim", wg, hg)
            s_acc.index_add_(0, pair_c.reshape(-1), pair_s.reshape(-1, bsz, dc, dc))
        ls = _cholesky(s_matrix(hcc - s_acc[:-1].reshape(C, C, bsz, dc, dc)))

        def apply_fn(rhs):
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
        # true max dofs per side: the elimination runs on (dc, dp) slices
        self.pt_d = int(pattern.var_dofs[self.pt_vars].max())
        self.cam_d = int(pattern.var_dofs[self.cam_vars].max()) if len(self.cam_vars) else pattern.d
        cam_index = np.full(n, -1, np.int64)
        cam_index[self.cam_vars] = np.arange(len(self.cam_vars))
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
        self.cc_i = np.concatenate([cam_index[ij[is_cc, 0]], np.arange(len(self.cam_vars))])
        self.cc_j = np.concatenate([cam_index[ij[is_cc, 1]], np.arange(len(self.cam_vars))])
        cam = np.where(ej, ij[:, 0], ij[:, 1])[is_cp]
        pt = np.where(ej, ij[:, 1], ij[:, 0])[is_cp]
        self.cp_slots = slots[is_cp]
        self.cp_cam = cam_index[cam]
        self.cp_pt = pt_index[pt]
        self.cp_tr = cam > pt  # the stored block has the point's rows
        self.pt_diag_slots = np.asarray([pattern.pair_slot[(v, v)] for v in self.pt_vars], np.int64)
        self._tables: Dict[str, Dict[str, torch.Tensor]] = {}
        self._chunks: Dict[tuple, tuple] = {}

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """The index tables as tensors on `device`, built once: a copy from
        the host inside the solver loop would synchronize the stream."""
        key = str(device)
        if key not in self._tables:
            long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)  # noqa: E731
            cc_off = np.flatnonzero(self.cc_i != self.cc_j)
            self._tables[key] = {
                "pt_diag_slots": long(self.pt_diag_slots),
                "cp_slots": long(self.cp_slots),
                "cp_tr": torch.as_tensor(self.cp_tr, dtype=torch.bool, device=device),
                "cp_cam": long(self.cp_cam),
                "cp_pt": long(self.cp_pt),
                "cc_slots": long(self.cc_slots),
                "cc_i": long(self.cc_i),
                "cc_j": long(self.cc_j),
                "cc_off": long(cc_off),
                "cc_i_off": long(self.cc_i[cc_off]),
                "cc_j_off": long(self.cc_j[cc_off]),
                "cam_vars": long(self.cam_vars),
                "pt_vars": long(self.pt_vars),
            }
        return self._tables[key]

    def use_dense_elimination(self, bsz: int, dtype: torch.dtype) -> bool:
        """True when the densified W and Hcp (B, C*dc, P*dp), plus one
        product transient of the same size, fit the configured budget."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        size = bsz * (len(self.cam_vars) * self.cam_d) * (len(self.pt_vars) * self.pt_d)
        return 3 * size * itemsize <= config.SCHUR_DENSE_BUDGET_BYTES

    def densify(self, blocks, t):
        """(O, B, dc, dp) coupling blocks -> (B, C*dc, P*dp) dense matrix."""
        C, P = len(self.cam_vars), len(self.pt_vars)
        bsz, dc, dp = blocks.shape[1:]
        dd = torch.zeros((C, P, bsz, dc, dp), dtype=blocks.dtype, device=blocks.device)
        dd[t["cp_cam"], t["cp_pt"]] = blocks  # each (camera, point) pair once
        return dd.permute(2, 0, 3, 1, 4).reshape(bsz, C * dc, P * dp)

    def ppad_tables(self):
        """(ppad_obs (P, K), ppad_valid (P, K), campair (P, K*K)): each point's
        observations padded to the largest count K, and the (camera,
        camera) pair of every two of them (C*C for padding)."""
        C, P, O = len(self.cam_vars), len(self.pt_vars), len(self.cp_pt)
        counts = np.bincount(self.cp_pt, minlength=P)
        K = max(1, int(counts.max()) if O else 1)
        order = np.argsort(self.cp_pt, kind="stable")
        starts = np.cumsum(counts) - counts
        pos = np.arange(O) - starts[self.cp_pt[order]]
        ppad_obs = np.zeros((P, K), dtype=np.int64)
        ppad_valid = np.zeros((P, K), dtype=bool)
        ppad_obs[self.cp_pt[order], pos] = order
        ppad_valid[self.cp_pt[order], pos] = True
        cam_at = np.where(ppad_valid, self.cp_cam[ppad_obs], 0)
        pairv = ppad_valid[:, :, None] & ppad_valid[:, None, :]
        campair = np.where(pairv, cam_at[:, :, None] * C + cam_at[:, None, :], C * C).reshape(P, K * K)
        return ppad_obs, ppad_valid, campair

    def chunk_tables(self, device, bsz: int, dc: int):
        """The padded per-point tables cut into chunks of points sized so that
        one chunk's pair tensor stays within _CHUNK_BYTES, on `device`."""
        key = (str(device), bsz, dc, _CHUNK_BYTES)
        if key not in self._chunks:
            ppad_obs, ppad_valid, campair = self.ppad_tables()
            C, P, K = len(self.cam_vars), len(self.pt_vars), ppad_obs.shape[1]
            chunk = max(1, min(P, _CHUNK_BYTES // max(1, K * K * bsz * dc * dc * 4)))
            n_chunks = -(-P // chunk)
            pad = n_chunks * chunk - P

            def cut(a, fill, dtype):
                a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
                return torch.as_tensor(a.reshape((n_chunks, chunk) + a.shape[1:]), dtype=dtype,
                                       device=device).unbind(0)

            self._chunks[key] = (cut(ppad_obs, 0, torch.long), cut(ppad_valid, False, torch.bool),
                                 cut(campair, C * C, torch.long))
        return self._chunks[key]

    def scatter_x(self, xc, xp):
        """(C, B, dc) camera and (P, B, dp) landmark steps -> (n, B, d)."""
        d = self.pattern.d
        t = self.tables(xc.device)
        xc = torch.nn.functional.pad(xc, (0, d - xc.shape[-1]))
        xp = torch.nn.functional.pad(xp, (0, d - xp.shape[-1]))
        x = torch.zeros((self.pattern.n_vars,) + tuple(xc.shape[1:]), dtype=xc.dtype, device=xc.device)
        x[t["cam_vars"]] = xc
        x[t["pt_vars"]] = xp
        return x


def eliminate_points(name: str, group) -> bool:
    """Default predicate: eliminate every Euclidean (Rn) variable."""
    return group.name.startswith("Rn")
