"""The assembly kernel's split plan and summation order, on the CPU.

`csrc/assemble_blocks.cu` cuts every contribution list longer than SPLIT
items into contiguous chunks, sums each chunk in one thread and combines
the partials in a fixed tree (shuffles within a warp, then warps in order).
The kernel itself runs only on the card (tests/test_torch_cuda.py); here:

- the split plan covers every item exactly once: each split output's chunks,
  concatenated, are its CSR list in order, every other output is short, and
  the CSR tables do not depend on the split;
- a numpy model of the kernel's order (chunks, thread partials, warp tree,
  warps in order; short outputs item by item) matches the plain twin
  `assemble_blocks_plain` to 1e-12 in float64, with SPLIT forced low so that
  PGO outputs split too.
"""

import numpy as np
import pytest
import torch

from theseus_tpu_torch import config
from theseus_tpu_torch.optim import LevenbergMarquardt
from theseus_tpu_torch.optim.normal import SparseNormalBuilder
from theseus_tpu_torch.sparse.assemble import _pad_jac
from theseus_tpu_torch.sparse.assemble_kernel import (
    GMAX,
    ITEMS_PER_CHUNK,
    SPLIT,
    SPLIT_THREADS,
    WARP,
    assemble_blocks_plain,
    build_assembly_tables,
    chunk_bounds,
    chunk_count,
    split_geometry,
)
from theseus_tpu_torch.utils.examples.bundle_adjustment import ba_values, build_ba_objective, synthetic_ba
from theseus_tpu_torch.utils.examples.pose_graph import build_pgo_objective, pose_values, synthetic_pose_graph

_CACHE = {}


def _problem(kind, batch):
    """(pattern, padded float64 blocks) of PGO 16 poses or BA 16 x 200."""
    key = (kind, batch)
    if key not in _CACHE:
        dt = torch.float64
        if kind == "pgo":
            gt, edges, meas, init = synthetic_pose_graph(16, batch, seed=0, dtype=dt, device="cpu")
            obj, _ = build_pgo_objective(16, edges, meas, gt[0], dtype=dt, device="cpu")
            values = obj.default_values(pose_values(init))
            pattern = SparseNormalBuilder(obj.compile()).pattern
        else:
            prob = synthetic_ba(16, 200, batch=batch, seed=0, visibility=0.4, dtype=dt, device="cpu")
            obj, _, _ = build_ba_objective(prob, dtype=dt, device="cpu")
            values = obj.default_values(ba_values(prob))
            pattern = LevenbergMarquardt(obj, linearization="schur").normal_builder.pattern
        co = obj.compile()
        bsz = co.resolve_batch_size(values)
        state, aux = co.pack(values, bsz), co.build_aux(values, bsz)
        with config.plain_path():
            blocks = co.linearize_blocks(state, aux)
        padded = [([_pad_jac(j, pattern.d) for j in jacs], err) for jacs, err in blocks]
        _CACHE[key] = (pattern, padded)
    return _CACHE[key]


# (problem, SPLIT): PGO lists hold at most 4 items, so only a low SPLIT splits them
PLANS = [("pgo", 1), ("pgo", 2), ("ba", 4), ("ba", SPLIT)]


@pytest.mark.parametrize("kind,split", PLANS)
def test_split_plan_covers_every_item_once(kind, split):
    pattern, _ = _problem(kind, 2)
    default = pattern.asm_tables
    t = build_assembly_tables(pattern, split=split)
    # the CSR tables are the same whatever the split
    for name in ("ata_ptr", "ata_items", "atb_ptr", "atb_items", "atb_gather"):
        np.testing.assert_array_equal(getattr(t, name), getattr(default, name), err_msg=name)
    counts = {0: np.diff(t.ata_ptr), 1: np.diff(t.atb_ptr)}
    assert len(t.split) > 0
    # longest first; each row's count and G follow from its list
    assert np.all(np.diff(t.split[:, 2]) <= 0)
    seen = {0: set(), 1: set()}
    for kind_, o, count, g in t.split:
        assert count == counts[kind_][o] > split
        assert g == chunk_count(count) == min(GMAX, -(-count // ITEMS_PER_CHUNK))
        bounds = chunk_bounds(count, g)
        # contiguous, non-empty, near-equal chunks that end at the list's end
        assert bounds[0] == 0 and bounds[-1] == count
        sizes = np.diff(bounds)
        assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
        ptr, items = (t.ata_ptr, t.ata_items) if kind_ == 0 else (t.atb_ptr, t.atb_items)
        chunks = [items[ptr[o] + a: ptr[o] + b] for a, b in zip(bounds[:-1], bounds[1:])]
        np.testing.assert_array_equal(np.concatenate(chunks), items[ptr[o]: ptr[o + 1]])
        assert o not in seen[kind_]
        seen[kind_].add(o)
    # every other output is short, listed once, in index order
    for kind_, short in ((0, t.short_ata), (1, t.short_atb)):
        np.testing.assert_array_equal(short, np.flatnonzero(counts[kind_] <= split))
        assert not seen[kind_] & set(short.tolist())
        assert len(seen[kind_]) + len(short) == len(counts[kind_])


@pytest.mark.parametrize("bsz,tile", [(1, 1), (2, 2), (3, 4), (8, 8), (16, 8), (128, 8)])
def test_split_geometry(bsz, tile):
    pattern, _ = _problem("ba", 2)
    t = pattern.asm_tables
    got_tile, n_large, threads = split_geometry(t, bsz)
    assert (got_tile, threads) == (tile, SPLIT_THREADS)
    # block-sized outputs (more chunks than a warp holds) form the prefix
    large = t.split[:, 3] * tile > WARP
    assert n_large == large.sum() and large[:n_large].all()
    assert split_geometry(build_assembly_tables(pattern, split=10 ** 9), bsz)[1:] == (0, 128)


def _items(t, kind, o):
    ptr, items = (t.ata_ptr, t.ata_items) if kind == 0 else (t.atb_ptr, t.atb_items)
    return items[ptr[o]: ptr[o + 1]]


def _contribution(t, blocks, kind, e):
    """One item's (B, d, d) or (B, d) term."""
    if kind == 0:
        (bs, ss), (bt, st) = t.sources[e[0]], t.sources[e[1]]
        js, jt = blocks[bs][0][ss][e[2]].numpy(), blocks[bt][0][st][e[2]].numpy()
        c = np.einsum("bmi,bmj->bij", js, jt)
        v = np.swapaxes(c, 1, 2) if e[3] & 1 else c
        return v + np.swapaxes(c, 1, 2) if e[3] & 2 else v
    b, s = t.sources[e[0]]
    return -np.einsum("bmi,bm->bi", blocks[b][0][s][e[1]].numpy(), blocks[b][1][e[1]].numpy())


def _model(t, blocks, bsz):
    """The kernel's summation order in numpy: short outputs item by item;
    split outputs by thread partials (chunks g = slot, slot + slots, ...),
    a shuffle-down tree within each warp, then the warps in order."""
    d = t.d
    ata = np.zeros((t.n_slots, bsz, d, d))
    atb = np.zeros((t.n_vars, bsz, d))
    for kind, out, short in ((0, ata, t.short_ata), (1, atb, t.short_atb)):
        for o in short:
            acc = np.zeros(out.shape[1:])
            for e in _items(t, kind, o):
                acc = acc + _contribution(t, blocks, kind, e)
            out[o] = acc
    tile, n_large, _ = split_geometry(t, bsz)
    lanes = WARP // tile  # chunk slots per warp
    for row, (kind, o, count, g) in enumerate(t.split):
        out = ata if kind == 0 else atb
        slots = SPLIT_THREADS // tile if row < n_large else lanes
        items = _items(t, kind, o)
        bounds = chunk_bounds(count, g)
        partial = [np.zeros(out.shape[1:]) for _ in range(slots)]
        for c in range(g):
            for e in items[bounds[c]: bounds[c + 1]]:
                partial[c % slots] = partial[c % slots] + _contribution(t, blocks, kind, e)
        warp_sums = []
        for w in range(slots // lanes):
            x = partial[w * lanes: (w + 1) * lanes]
            step = lanes // 2
            while step >= 1:
                x = [x[i] + x[i + step] if i < step else x[i] for i in range(lanes)]
                step //= 2
            warp_sums.append(x[0])
        acc = warp_sums[0]
        for w in warp_sums[1:]:
            acc = acc + w
        out[o] = acc
    return ata, atb


@pytest.mark.parametrize("kind,split,bsz", [("pgo", 1, 4), ("pgo", 2, 4), ("ba", 4, 2), ("ba", SPLIT, 2),
                                            ("ba", SPLIT, 1)])
def test_kernel_order_model_matches_twin(kind, split, bsz):
    pattern, blocks = _problem(kind, bsz)
    t = build_assembly_tables(pattern, split=split)
    assert len(t.split) > 0
    ata, atb = _model(t, blocks, bsz)
    want_ata, want_atb = assemble_blocks_plain(pattern, blocks)
    for got, want in ((ata, want_ata.numpy()), (atb, want_atb.numpy())):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=1e-12 * scale, rtol=0)
