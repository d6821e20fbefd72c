"""Block AtA / Atb assembly from per-bucket jacobian blocks (JAX counterpart: theseus_tpu/sparse/assemble.py).

The block pattern is static, so it is built once on the host (numpy):
canonical (i <= j) block slots, per-bucket scatter schedules, and the CSR
tables the assembly kernel reads. All blocks are padded to a uniform dof
`d`; padding dims get identity diagonals so the factorization stays
well-posed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import config
from .assemble_kernel import AssemblyTables, assemble_blocks, build_assembly_tables
from .refine import MatvecTables, hp_dtype, matvec_tables


@dataclasses.dataclass
class BlockPattern:
    """Static AtA block pattern + scatter schedules (numpy)."""

    n_vars: int
    d: int  # uniform (max) block dof
    var_dofs: np.ndarray  # (n,) true dof per var
    pair_slot: Dict[Tuple[int, int], int]  # canonical (i<=j) -> slot (1-based)
    n_slots: int  # number of stored blocks + 1 (slot 0 = zero sentinel)
    pairs: Set[Tuple[int, int]]  # off-diagonal canonical pairs
    # per bucket: list over (s, t) pairs of
    #   (s, t, tgt_slot (K,), needs_T (K,), also_diag (K,))
    bucket_pair_sched: List[List[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]]
    # per bucket: per slot s, global var ids (K,)
    bucket_gvars: List[List[np.ndarray]]
    pad_diag: np.ndarray  # (n, d) 1.0 on padding dims of each var's diag block
    dof_mask: np.ndarray  # (n, d) 1.0 on true dims
    asm_tables: Optional[AssemblyTables] = None
    _device: Dict[tuple, object] = dataclasses.field(default_factory=dict, repr=False)

    def masks(self, device, dtype) -> Dict[str, torch.Tensor]:
        """pad_diag and dof_mask as tensors on `device`, built once: a copy
        from the host inside the solver loop would synchronize the stream."""
        key = (str(device), dtype)
        if key not in self._device:
            self._device[key] = {
                "pad_diag": torch.as_tensor(self.pad_diag, dtype=dtype, device=device),
                "dof_mask": torch.as_tensor(self.dof_mask, dtype=dtype, device=device),
            }
        return self._device[key]

    def matvec_tables(self, device) -> MatvecTables:
        """Gather tables of the iterative-refinement block SpMV, as tensors
        on `device` (built once per device)."""
        key = ("matvec", str(device))
        if key not in self._device:
            t = matvec_tables(self.pair_slot, self.n_vars)
            self._device[key] = MatvecTables(*(torch.as_tensor(a, device=device) for a in t))
        return self._device[key]


def build_block_pattern(co) -> BlockPattern:
    n_vars = len(co.var_names)
    var_dofs = np.array([co.var_groups[n].dof for n in co.var_names])
    d = int(var_dofs.max())

    # global var id per slot from the tangent-column table, then one
    # np.unique over all off-diagonal (lo, hi) keys to number the slots
    col2var = np.repeat(np.arange(n_vars, dtype=np.int32), var_dofs.astype(np.int64))

    bucket_gvars: List[List[np.ndarray]] = []
    raw_scheds: List[List] = []  # (s, t, lo, hi, needs_t, also_diag)
    all_off_keys = []
    for bk in co.buckets:
        gvars = [col2var[np.asarray(s.cols)[:, 0]] for s in bk.optim_slots]
        bucket_gvars.append(gvars)
        sched = []
        nslots = len(bk.optim_slots)
        for s in range(nslots):
            for t in range(s, nslots):
                a, b = gvars[s], gvars[t]
                lo = np.minimum(a, b)
                hi = np.maximum(a, b)
                # J_s^T J_t is stored at canonical orientation (lo, hi)
                needs_t = a > b
                # same var in two slots of one cost: diagonal gets C + C^T
                also_diag = (s != t) & (a == b)
                sched.append((s, t, lo, hi, needs_t, also_diag))
                off = lo != hi
                if off.any():
                    all_off_keys.append(lo[off].astype(np.int64) * n_vars + hi[off])
        raw_scheds.append(sched)

    uniq_off = (
        np.unique(np.concatenate(all_off_keys)) if all_off_keys else np.empty(0, np.int64)
    )
    # slots: 0 = zero sentinel, 1..n_vars = diagonal blocks, then
    # off-diagonal pairs in sorted-key order
    pair_slot: Dict[Tuple[int, int], int] = {(i, i): i + 1 for i in range(n_vars)}
    pairs: Set[Tuple[int, int]] = set()
    for r, key in enumerate(uniq_off):
        lo, hi = divmod(int(key), n_vars)
        pair_slot[(lo, hi)] = n_vars + 1 + r
        pairs.add((lo, hi))
    slot = n_vars + 1 + len(uniq_off)

    bucket_pair_sched: List[List] = []
    for sched in raw_scheds:
        out = []
        for (s, t, lo, hi, needs_t, also_diag) in sched:
            key = lo.astype(np.int64) * n_vars + hi
            tgt = np.where(
                lo == hi, lo + 1, n_vars + 1 + np.searchsorted(uniq_off, key)
            ).astype(np.int32)
            out.append((s, t, tgt, needs_t, also_diag))
        bucket_pair_sched.append(out)

    pad_diag = np.zeros((n_vars, d))
    dof_mask = np.zeros((n_vars, d))
    for i, dv in enumerate(var_dofs):
        pad_diag[i, dv:] = 1.0
        dof_mask[i, :dv] = 1.0

    pattern = BlockPattern(
        n_vars=n_vars,
        d=d,
        var_dofs=var_dofs,
        pair_slot=pair_slot,
        n_slots=slot,
        pairs=pairs,
        bucket_pair_sched=bucket_pair_sched,
        bucket_gvars=bucket_gvars,
        pad_diag=pad_diag,
        dof_mask=dof_mask,
    )
    pattern.asm_tables = build_assembly_tables(pattern)
    return pattern


def _pad_jac(jac: torch.Tensor, d: int) -> torch.Tensor:
    """(K, B, dim, dof) -> (K, B, dim, d)."""
    dof = jac.shape[-1]
    if dof == d:
        return jac
    return torch.nn.functional.pad(jac, (0, d - dof))


def assemble(pattern: BlockPattern, blocks):
    """blocks = co.linearize_blocks(state, aux). Returns
    (ata_flat (n_slots, B, d, d), atb (n_vars, B, d)); ata slot 0 is zeros;
    padding dims carry identity diagonals. With the high-precision tier on
    (config.HIGH_PRECISION_TIER), Atb is recomputed with float64
    accumulation outside the kernel, as the JAX package does under x64."""
    d = pattern.d
    dtype = blocks[0][1].dtype
    padded = [([_pad_jac(j, d) for j in jacs], err) for jacs, err in blocks]
    ata, atb = assemble_blocks(pattern, padded)
    if pattern.pad_diag.any():
        diag_slots = slice(1, pattern.n_vars + 1)
        pad = pattern.masks(ata.device, dtype)["pad_diag"]
        ata[diag_slots] = ata[diag_slots] + torch.diag_embed(pad)[:, None]
    if config.ATB_HIGH_PRECISION and hp_dtype(dtype) != dtype:
        atb = _assemble_atb_hp(pattern, padded, dtype)
    return ata, atb


def _assemble_atb_hp(pattern: BlockPattern, blocks, dtype):
    """Atb = -sum J_s^T e accumulated in float64 and cast back to the
    working dtype at the end. Each var's contributions are summed in the
    fixed order of the assembly CSR (a padded gather, no atomics)."""
    hp = torch.float64
    tables = pattern.asm_tables
    err0 = blocks[0][1]
    dev, bsz, d = err0.device, err0.shape[1], pattern.d
    contribs = [torch.zeros((1, bsz, d), dtype=hp, device=dev)]  # row 0: zero sentinel
    for bi, s in tables.sources:
        jacs, err = blocks[bi]
        contribs.append(-torch.einsum("kbmi,kbm->kbi", jacs[s].to(hp), err.to(hp)))
    rows = torch.cat(contribs, dim=0)
    idx = tables.on(dev)[4]  # (n_vars, maxdeg)
    return rows[idx].sum(dim=1).to(dtype)


def apply_block_damping(pattern: BlockPattern, ata, damping, ellipsoidal: bool, eps: float):
    """diag <- diag*(1+a) + b on true dofs of diagonal blocks."""
    dtype, dev = ata.dtype, ata.device
    if isinstance(damping, torch.Tensor):
        damping = damping.to(dtype).expand(ata.shape[1])
    else:  # a Python number: filled on the device, no host copy
        damping = torch.full((ata.shape[1],), float(damping), dtype=dtype, device=dev)
    if ellipsoidal:
        alpha, beta = damping, torch.full_like(damping, eps)
    else:
        alpha, beta = torch.zeros_like(damping), damping
    dmask = pattern.masks(dev, dtype)["dof_mask"]  # (n, d)
    diag_slots = slice(1, pattern.n_vars + 1)
    dblocks = ata[diag_slots]  # (n, B, d, d)
    diag = torch.diagonal(dblocks, dim1=-2, dim2=-1)  # (n, B, d)
    add = alpha[None, :, None] * diag + beta[None, :, None] * dmask[:, None, :]
    out = ata.clone()
    out[diag_slots] = dblocks + torch.diag_embed(add)
    return out
