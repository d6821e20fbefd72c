"""Fused AtA / Atb block assembly: CUDA kernel and plain twin (JAX counterpart: theseus_tpu/sparse/pallas_assemble.py).

`assemble_blocks(tables, blocks)` sums, for every cost bucket, J_s^T J_t
into each stored lower-triangle block slot of AtA and -J_s^T r into each
Atb row. On a CUDA tensor it launches `csrc/assemble_blocks.cu`, an
owner-computes reduction over the host-built CSR lists of `AssemblyTables`
(no floating-point atomics, so the sum order is fixed); on a CPU tensor it
runs `assemble_blocks_plain`, the model of the JAX package's
`_assemble_xla` (without its padding epilogue, which `assemble.assemble`
applies to both). While autograd records, the call goes through an autograd
Function whose backward differentiates that twin.

Long lists are split. An output (AtA slot or Atb row) with more than
`SPLIT` contributions is cut into G = min(GMAX, ceil(count /
ITEMS_PER_CHUNK)) contiguous chunks of its CSR list, and the threads of
one block (or, when the chunks fit, one warp) sum one chunk each and
combine the partials in a fixed tree. Every other output is summed item by
item, one thread per (output, batch element, block row). The plan depends
on the pattern alone, and the launch geometry on the pattern and the batch
size (`split_geometry`), never on the data: two launches on the same
inputs give the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import _cuda
from ..config import needs_grad, use_kernel
from ..ops.batched_linalg import SMALL_DIM_MAX
from ..tracing import span

# the kernel takes its jacobian / error pointers in its parameter block; an
# objective with more (bucket, slot) sources (one bucket per cost, as
# compile(vectorize=False) makes) is launched with its buckets merged
# (`merge_sources`)
MAX_SOURCES = 32

# The split plan. An output with at most SPLIT items costs at most SPLIT
# dependent item loads in one thread, about what a chunk and the tree cost;
# beyond that it is split. At BA 128 x 4000 the camera rows (~1,600 items)
# become 256 chunks of 6-7 and the point rows (~51) 13 chunks of 3-4; the
# camera-point slots (1 item) and every PGO output (at most 4) stay whole.
# Of 2, 4, 8 and 16 items a chunk, 4 was fastest there on the H100
# (chip_smoke.py times the four).
SPLIT = 16
ITEMS_PER_CHUNK = 4
SPLIT_THREADS = 256  # threads of a block that reduces one long output
GMAX = SPLIT_THREADS  # chunks per output: one thread each at B = 1
BATCH_TILE_MAX = 8  # batch elements per split block (lanes on one item)
WARP = 32
SHORT_THREADS = 128  # block size of a launch without split outputs


@dataclasses.dataclass
class AssemblyTables:
    """Host CSR tables from each output to its ordered contributions.

    sources: one (bucket, optim slot) per jacobian tensor the kernel reads.
    ata_ptr (n_slots + 1,), ata_items (n, 4) int32: (src_s, src_t, edge,
    flags) with flags bit 0 = store the transpose, bit 1 = also add the
    transpose. atb_ptr (n_vars + 1,), atb_items (n, 2): (src, edge). Items
    are ordered by (bucket, slot pair, edge) within each output.

    The split plan: split (n_split, 4) int32 rows (kind 0 = AtA slot /
    1 = Atb row, output, count, G), longest list first; short_ata and
    short_atb list the outputs of at most `split` items, in index order."""

    n_slots: int
    n_vars: int
    d: int
    sources: List[Tuple[int, int]]
    ata_ptr: np.ndarray
    ata_items: np.ndarray
    atb_ptr: np.ndarray
    atb_items: np.ndarray
    atb_gather: np.ndarray
    split: np.ndarray
    short_ata: np.ndarray
    short_atb: np.ndarray
    _device: Dict[str, tuple] = dataclasses.field(default_factory=dict, repr=False)
    _merged: Dict[tuple, tuple] = dataclasses.field(default_factory=dict, repr=False)

    def on(self, device: torch.device):
        """The tables as tensors on `device`, built once per device:
        (ata_ptr, ata_items, atb_ptr, atb_items, atb_gather, split,
        short_ata, short_atb)."""
        key = str(device)
        if key not in self._device:
            i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device).contiguous()  # noqa: E731
            self._device[key] = (
                i32(self.ata_ptr), i32(self.ata_items), i32(self.atb_ptr), i32(self.atb_items),
                torch.as_tensor(self.atb_gather, dtype=torch.long, device=device),
                i32(self.split), i32(self.short_ata), i32(self.short_atb),
            )
        return self._device[key]


def chunk_count(count: int) -> int:
    """G, the number of chunks of a split list of `count` items."""
    return min(GMAX, -(-count // ITEMS_PER_CHUNK))


def chunk_bounds(count: int, n_chunks: int) -> np.ndarray:
    """Offsets (n_chunks + 1,) of the chunks within the list: contiguous,
    in CSR order, the first count % n_chunks one item longer (the kernel's
    rule: chunk g starts at g q + min(g, count % n_chunks))."""
    q, rem = divmod(count, n_chunks)
    g = np.arange(n_chunks + 1)
    return g * q + np.minimum(g, rem)


def split_plan(ata_ptr: np.ndarray, atb_ptr: np.ndarray, split: int = SPLIT):
    """(split rows, short AtA slots, short Atb rows) from the list lengths."""
    counts = [np.diff(ata_ptr), np.diff(atb_ptr)]
    rows = [(kind, int(o), int(c), chunk_count(int(c)))
            for kind, cnt in enumerate(counts) for o, c in enumerate(cnt) if c > split]
    rows.sort(key=lambda r: -r[2])  # stable: ties keep (kind, output) order
    short = [np.flatnonzero(cnt <= split).astype(np.int32) for cnt in counts]
    return np.asarray(rows, np.int32).reshape(-1, 4), short[0], short[1]


def split_geometry(tables: AssemblyTables, bsz: int):
    """(tile, n_large, threads) of one launch at batch size bsz. A split
    block covers `tile` batch elements (the fastest lane index, so lanes on
    one item read neighbouring jacobian rows) and SPLIT_THREADS // tile
    chunks. The first n_large split outputs have more chunks than one warp
    holds (G tile > 32) and get a block each; the rest get one warp each."""
    if len(tables.split) == 0:
        return 1, 0, SHORT_THREADS
    tile = min(BATCH_TILE_MAX, 1 << max(0, bsz - 1).bit_length())
    n_large = int((tables.split[:, 3] * tile > WARP).sum())
    return tile, n_large, SPLIT_THREADS


def build_assembly_tables(pattern, split: int = SPLIT) -> AssemblyTables:
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
    split_rows, short_ata, short_atb = split_plan(ata_ptr, atb_ptr, split)
    return AssemblyTables(
        n_slots=pattern.n_slots, n_vars=pattern.n_vars, d=pattern.d, sources=sources,
        ata_ptr=ata_ptr, ata_items=ata_items, atb_ptr=atb_ptr, atb_items=atb_items,
        atb_gather=atb_gather, split=split_rows, short_ata=short_ata, short_atb=short_atb,
    )


def merge_sources(tables: AssemblyTables, pattern, ms):
    """The launch form of tables whose sources exceed MAX_SOURCES: buckets
    with the same slot count and residual dimension m (ms, per bucket) are
    concatenated along the edge axis, in bucket order, into one bucket of
    their class, so a source is a (class, slot) pair and an item's edge is
    its bucket's offset in the class plus its own. Item order, and so the
    sum order and the bits, stay as they are. Returns (tables with those
    sources and items, the buckets of each class); cached per ms."""
    key = tuple(ms)
    if key not in tables._merged:
        nslots = [len(g) for g in pattern.bucket_gvars]
        classes: Dict[Tuple[int, int], List[int]] = {}
        for bi in dict.fromkeys(bi for bi, _ in tables.sources):
            classes.setdefault((nslots[bi], ms[bi]), []).append(bi)
        members = list(classes.values())
        cls_of, offset = {}, {}
        for ci, buckets in enumerate(members):
            off = 0
            for bi in buckets:
                cls_of[bi], offset[bi] = ci, off
                off += len(pattern.bucket_gvars[bi][0])
        sources = [(ci, sl) for ci, buckets in enumerate(members) for sl in range(nslots[buckets[0]])]
        src_of = {src: i for i, src in enumerate(sources)}
        new_src = np.array([src_of[(cls_of[bi], sl)] for bi, sl in tables.sources], np.int32)
        src_off = np.array([offset[bi] for bi, _ in tables.sources], np.int32)
        ata = tables.ata_items.copy()
        ata[:, 2] += src_off[ata[:, 0]]
        ata[:, 0], ata[:, 1] = new_src[ata[:, 0]], new_src[ata[:, 1]]
        atb = tables.atb_items.copy()
        atb[:, 1] += src_off[atb[:, 0]]
        atb[:, 0] = new_src[atb[:, 0]]
        if len(sources) > MAX_SOURCES:
            raise ValueError(f"assemble_blocks: {len(sources)} (bucket class, slot) sources exceed the "
                             f"kernel's {MAX_SOURCES}")
        merged = dataclasses.replace(tables, sources=sources, ata_items=ata, atb_items=atb, _device={}, _merged={})
        tables._merged[key] = (merged, members)
    return tables._merged[key]


def merge_blocks(members, blocks):
    """The blocks of each class of `merge_sources`: its buckets' jacobians
    (per slot) and errors concatenated along the edge axis."""
    out = []
    for buckets in members:
        if len(buckets) == 1:
            out.append(blocks[buckets[0]])
            continue
        jacs = [torch.cat([blocks[bi][0][sl] for bi in buckets]) for sl in range(len(blocks[buckets[0]][0]))]
        out.append((jacs, torch.cat([blocks[bi][1] for bi in buckets])))
    return out


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


def _flatten(blocks):
    """blocks -> (layout: jacobians per bucket, flat tensors jac..., err per bucket)."""
    layout = tuple(len(jacs) for jacs, _ in blocks)
    flat = [t for jacs, err in blocks for t in (*jacs, err)]
    return layout, flat


def _unflatten(layout, flat):
    out, i = [], 0
    for n in layout:
        out.append((list(flat[i : i + n]), flat[i + n]))
        i += n + 1
    return out


class _AssembleBlocks(torch.autograd.Function):
    """Forward: the kernel. Backward: the VJP of `assemble_blocks_plain`,
    which is bilinear in the jacobians and errors (the JAX package's
    `_asm_bwd`, the VJP of `_assemble_xla`)."""

    @staticmethod
    def forward(ctx, pattern, layout, *flat):
        ctx.pattern, ctx.layout = pattern, layout
        ctx.save_for_backward(*flat)
        return _assemble_forward(pattern, _unflatten(layout, flat))

    @staticmethod
    def backward(ctx, g_ata, g_atb):
        with span("tt.backward.assemble"):
            wants = ctx.needs_input_grad[2:]
            prims = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wants)]
            with torch.enable_grad():
                outs = assemble_blocks_plain(ctx.pattern, _unflatten(ctx.layout, prims))
            leaves = [p for p, w in zip(prims, wants) if w]
            grads = iter(torch.autograd.grad(outs, leaves, (g_ata, g_atb), allow_unused=True))
            return (None, None) + tuple(next(grads) if w else None for w in wants)


def assemble_blocks(pattern, blocks):
    """Kernel on CUDA, twin on CPU; same contract as assemble_blocks_plain.
    Differentiable in the jacobians and errors."""
    layout, flat = _flatten(blocks)
    if needs_grad(*flat):
        return _AssembleBlocks.apply(pattern, layout, *flat)
    return _assemble_forward(pattern, blocks)


def _assemble_forward(pattern, blocks):
    err0 = blocks[0][1]
    if not use_kernel(err0):
        return assemble_blocks_plain(pattern, blocks)
    tables = pattern.asm_tables
    d = tables.d
    if d > SMALL_DIM_MAX:
        raise ValueError(f"assemble_blocks: the CUDA kernel takes d <= {SMALL_DIM_MAX}, got {d}")
    if len(tables.sources) > MAX_SOURCES:
        tables, members = merge_sources(tables, pattern, [int(err.shape[2]) for _, err in blocks])
        blocks = merge_blocks(members, blocks)
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
    ata_ptr, ata_items, atb_ptr, atb_items, _, split, short_ata, short_atb = tables.on(dev)
    tile, n_large, threads = split_geometry(tables, bsz)
    ata = torch.empty((tables.n_slots, bsz, d, d), dtype=dtype, device=dev)
    atb = torch.empty((tables.n_vars, bsz, d), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = fn(c_jac, c_err, c_m, n,
                ata_ptr.data_ptr(), ata_items.data_ptr(), atb_ptr.data_ptr(), atb_items.data_ptr(),
                split.data_ptr(), len(tables.split), n_large, tile, threads,
                short_ata.data_ptr(), len(tables.short_ata), short_atb.data_ptr(), len(tables.short_atb),
                bsz, d, int(all(p % 16 == 0 for p in jac_ptrs)), ata.data_ptr(), atb.data_ptr(),
                _cuda.stream_of(err0))
    _cuda.check(rc, "assemble_blocks")
    _cuda.launches["assemble_blocks"] += 1
    del keep
    return ata, atb
