"""Fused AtA / Atb block assembly: CUDA kernel and plain twin (JAX counterpart: theseus_tpu/sparse/pallas_assemble.py).

`assemble_blocks(tables, blocks)` sums, for every cost bucket, J_s^T J_t
into each stored lower-triangle block slot of AtA and -J_s^T r into each
Atb row. On a CUDA tensor it launches `csrc/assemble_blocks.cu`, an
owner-computes reduction over the host-built CSR lists of `AssemblyTables`
(no floating-point atomics, so the sum order is fixed); on a CPU tensor it
runs `assemble_blocks_plain`, the model of the JAX package's
`_assemble_xla` (without its padding epilogue, which `assemble.assemble`
applies to both).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import _cuda
from ..config import check_no_grad, use_kernel
from ..ops.batched_linalg import SMALL_DIM_MAX

# the kernel takes its jacobian / error pointers in its parameter block
MAX_SOURCES = 32


@dataclasses.dataclass
class AssemblyTables:
    """Host CSR tables from each output to its ordered contributions.

    sources: one (bucket, optim slot) per jacobian tensor the kernel reads.
    ata_ptr (n_slots + 1,), ata_items (n, 4) int32: (src_s, src_t, edge,
    flags) with flags bit 0 = store the transpose, bit 1 = also add the
    transpose. atb_ptr (n_vars + 1,), atb_items (n, 2): (src, edge). Items
    are ordered by (bucket, slot pair, edge) within each output."""

    n_slots: int
    n_vars: int
    d: int
    sources: List[Tuple[int, int]]
    ata_ptr: np.ndarray
    ata_items: np.ndarray
    atb_ptr: np.ndarray
    atb_items: np.ndarray
    atb_gather: np.ndarray
    _device: Dict[str, tuple] = dataclasses.field(default_factory=dict, repr=False)

    def on(self, device: torch.device):
        """The tables as tensors on `device`, built once per device."""
        key = str(device)
        if key not in self._device:
            self._device[key] = tuple(
                torch.as_tensor(a, dtype=torch.int32, device=device).contiguous()
                for a in (self.ata_ptr, self.ata_items, self.atb_ptr, self.atb_items)
            ) + (torch.as_tensor(self.atb_gather, dtype=torch.long, device=device),)
        return self._device[key]


def build_assembly_tables(pattern) -> AssemblyTables:
    sources: List[Tuple[int, int]] = []
    src_of: Dict[Tuple[int, int], int] = {}
    for bi, gvars in enumerate(pattern.bucket_gvars):
        for s in range(len(gvars)):
            src_of[(bi, s)] = len(sources)
            sources.append((bi, s))

    ata_tgt, ata_rows = [], []
    atb_tgt, atb_rows = [], []
    for bi, sched in enumerate(pattern.bucket_pair_sched):
        for (s, t, tgt, needs_t, also_diag) in sched:
            k = len(tgt)
            flags = needs_t.astype(np.int32) | (also_diag.astype(np.int32) << 1)
            ata_tgt.append(np.asarray(tgt, np.int64))
            ata_rows.append(np.stack([
                np.full(k, src_of[(bi, s)], np.int32),
                np.full(k, src_of[(bi, t)], np.int32),
                np.arange(k, dtype=np.int32),
                flags,
            ], axis=1))
        for s, gv in enumerate(pattern.bucket_gvars[bi]):
            k = len(gv)
            atb_tgt.append(np.asarray(gv, np.int64))
            atb_rows.append(np.stack([
                np.full(k, src_of[(bi, s)], np.int32),
                np.arange(k, dtype=np.int32),
            ], axis=1))

    def csr(targets, rows, n_out, width):
        if not targets:
            return np.zeros(n_out + 1, np.int32), np.zeros((0, width), np.int32)
        tgt = np.concatenate(targets)
        items = np.concatenate(rows, axis=0)
        order = np.argsort(tgt, kind="stable")  # keeps (bucket, pair, edge) order
        counts = np.bincount(tgt, minlength=n_out)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        return ptr, np.ascontiguousarray(items[order], dtype=np.int32)

    ata_ptr, ata_items = csr(ata_tgt, ata_rows, pattern.n_slots, 4)
    atb_ptr, atb_items = csr(atb_tgt, atb_rows, pattern.n_vars, 2)

    # the same Atb lists as a padded (n_vars, maxdeg) gather into the rows of
    # all sources' -J^T e stacked after one zero sentinel row (used by the
    # float64 Atb of the high-precision tier)
    ks = [len(pattern.bucket_gvars[bi][s]) for bi, s in sources]
    src_base = 1 + np.concatenate([[0], np.cumsum(ks)[:-1]]).astype(np.int64)
    counts = np.diff(atb_ptr)
    atb_gather = np.zeros((pattern.n_vars, max(1, int(counts.max(initial=0)))), np.int64)
    row = np.repeat(np.arange(pattern.n_vars), counts)
    pos = np.arange(len(atb_items)) - atb_ptr[row]
    atb_gather[row, pos] = src_base[atb_items[:, 0]] + atb_items[:, 1]
    return AssemblyTables(
        n_slots=pattern.n_slots, n_vars=pattern.n_vars, d=pattern.d, sources=sources,
        ata_ptr=ata_ptr, ata_items=ata_items, atb_ptr=atb_ptr, atb_items=atb_items,
        atb_gather=atb_gather,
    )


def assemble_blocks_plain(pattern, blocks):
    """blocks: per bucket ((jac per slot (K, B, m, d)), err (K, B, m)) with
    jacobians already padded to d. Returns (ata (n_slots, B, d, d) with slot 0
    zero, atb (n_vars, B, d))."""
    d = pattern.d
    err0 = blocks[0][1]
    bsz, dtype, dev = err0.shape[1], err0.dtype, err0.device
    ata = torch.zeros((pattern.n_slots, bsz, d, d), dtype=dtype, device=dev)
    atb = torch.zeros((pattern.n_vars, bsz, d), dtype=dtype, device=dev)
    for bi, (jacs, err) in enumerate(blocks):
        for s, jac in enumerate(jacs):
            contrib = -torch.einsum("kbmi,kbm->kbi", jac, err)
            idx = torch.as_tensor(pattern.bucket_gvars[bi][s], dtype=torch.long, device=dev)
            atb.index_add_(0, idx, contrib)
        for (s, t, tgt, needs_t, also_diag) in pattern.bucket_pair_sched[bi]:
            c = torch.einsum("kbmi,kbmj->kbij", jacs[s], jacs[t])
            tr = torch.as_tensor(needs_t, device=dev)[:, None, None, None]
            cc = torch.where(tr, c.transpose(-1, -2), c)
            idx = torch.as_tensor(tgt, dtype=torch.long, device=dev)
            ata.index_add_(0, idx, cc)
            if also_diag.any():
                ad = torch.as_tensor(also_diag, device=dev)[:, None, None, None]
                extra = torch.where(ad, cc.transpose(-1, -2), torch.zeros_like(cc))
                ata.index_add_(0, idx, extra)
    return ata, atb


def assemble_blocks(pattern, blocks):
    """Kernel on CUDA, twin on CPU; same contract as assemble_blocks_plain."""
    tensors = [j for jacs, _ in blocks for j in jacs] + [e for _, e in blocks]
    check_no_grad(*tensors)
    err0 = blocks[0][1]
    if not use_kernel(err0):
        return assemble_blocks_plain(pattern, blocks)
    tables = pattern.asm_tables
    d = tables.d
    if d > SMALL_DIM_MAX:
        raise ValueError(f"assemble_blocks: the CUDA kernel takes d <= {SMALL_DIM_MAX}, got {d}")
    if len(tables.sources) > MAX_SOURCES:
        raise ValueError(
            f"assemble_blocks: {len(tables.sources)} (bucket, slot) sources exceed the "
            f"kernel's {MAX_SOURCES}"
        )
    dev, dtype, bsz = err0.device, err0.dtype, err0.shape[1]
    fn = getattr(_cuda.lib(), f"th_assemble_blocks_{_cuda.suffix(dtype)}")
    keep = []  # references that must outlive the launch
    jac_ptrs, err_ptrs, ms = [], [], []
    for bi, s in tables.sources:
        jacs, err = blocks[bi]
        jac = jacs[s].contiguous()
        err = err.contiguous()
        if jac.dtype != dtype or jac.device != dev or jac.shape[1] != bsz or jac.shape[-1] != d:
            raise ValueError(f"assemble_blocks: jacobian of bucket {bi} slot {s} has shape "
                             f"{tuple(jac.shape)} / {jac.dtype} / {jac.device}")
        keep += [jac, err]
        jac_ptrs.append(jac.data_ptr())
        err_ptrs.append(err.data_ptr())
        ms.append(int(err.shape[2]))
    n = len(jac_ptrs)
    c_jac = (ctypes.c_void_p * n)(*jac_ptrs)
    c_err = (ctypes.c_void_p * n)(*err_ptrs)
    c_m = (ctypes.c_int * n)(*ms)
    ata_ptr, ata_items, atb_ptr, atb_items, _ = tables.on(dev)
    ata = torch.empty((tables.n_slots, bsz, d, d), dtype=dtype, device=dev)
    atb = torch.empty((tables.n_vars, bsz, d), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = fn(c_jac, c_err, c_m, n,
                ata_ptr.data_ptr(), ata_items.data_ptr(), tables.n_slots,
                atb_ptr.data_ptr(), atb_items.data_ptr(), tables.n_vars,
                bsz, d, ata.data_ptr(), atb.data_ptr(), _cuda.stream_of(err0))
    _cuda.check(rc, "assemble_blocks")
    _cuda.launches["assemble_blocks"] += 1
    del keep
    return ata, atb
