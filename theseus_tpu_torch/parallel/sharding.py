"""Batch-axis and factor-axis sharding of NLLS solves over several devices (JAX counterpart: theseus_tpu/parallel/sharding.py).

Every state stack is (N_instances, B, *elem), every stacked aux tensor
(K, B, *shape) and every shared aux tensor (B, *shape), so splitting B over
a mesh of devices ("dp") turns one batched solve into independent solves,
one a device, with no traffic between them: only the outer loss crosses
devices, through the join of the carries. GBP can also split one problem's
factors over the mesh (`shard_gbp_factors`): each device passes the
messages of its chunk of factors, and the beliefs are summed on the home
device and read back by every chunk.

The JAX package hands the placement to XLA (`NamedSharding`, `shard_map`,
collectives it inserts). Here it is explicit, in one process and one host
thread: `shard_problem` slices and copies, `shard_map_solve` runs the
shards one after another, each under `torch.cuda.device(...)`, and joins
their carries on the home device with `.to()` and `torch.cat`. Nothing
here uses `torch.distributed`.

Where trouble lies:

- The kernel wrappers launch on the stream of their tensor's device
  (`_cuda.stream_of`), but the CUDA sources set their shared-memory
  attribute (`cudaFuncSetAttribute`) on the *current* device before they
  launch. A shard on cuda:1 launched while cuda:0 is current would fail or
  run with the attribute unset, so each shard runs under
  `torch.cuda.device(shard_device)` (`_on_device`). One card cannot show
  this: a mesh of [cuda:0, cuda:0] runs every shard on the current device.
- Per-device tables: the compiled objective's index tables, the normal
  builders' tables (sparse, Schur, PCG, whole-sweep plan, GBP's variable
  ids) and the assembly's tables are built once a device, keyed by the
  device, so every shard finds its own. The launch geometry caches hold
  numbers only.
- The solver loop is host-bound (the device idles most of an LM
  iteration), so shards run in turn from one thread do not overlap: a
  mesh buys memory and separate cards, not speed, until the shards are
  driven from threads or processes of their own.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch

from ..core.compiled import CompiledObjective
from ..optim.gbp import GBPNormal, GBPNormalBuilder, _blk


class P(tuple):
    """A partition spec, as `jax.sharding.PartitionSpec`: entry i names the
    mesh axis that splits dimension i, None leaves it whole; P() is a
    replicated leaf."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def batch_dim(spec: P, axis: str) -> Optional[int]:
    """The dimension of `spec` that `axis` splits, None for a replicated leaf."""
    return spec.index(axis) if axis in spec else None


class Mesh:
    """An ordered list of devices along one named axis. A device may appear
    more than once: each entry is one shard."""

    def __init__(self, devices: Sequence, axis: str = "dp"):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis = axis
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def home(self) -> torch.device:
        """The device that holds joined carries, beliefs and unsplit factors."""
        return self.devices[0]

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp", devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first `n_devices` CUDA cards (all of them by
    default), or over `devices`, an explicit list that may repeat a device
    (["cpu"] * 8 on the CPU, [cuda:0, cuda:0] on one card: the analog of
    the JAX package's virtual host devices). Raises, naming the count, when
    fewer cards are present than asked for."""
    if devices is not None:
        devs = list(devices)
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"make_mesh({n_devices}) was given {len(devs)} devices")
            devs = devs[:n_devices]
        return Mesh(devs, axis)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or n_cards
    if n < 1 or n_cards < n:
        raise ValueError(f"make_mesh({n_devices}) needs {max(n, 1)} CUDA devices but {n_cards} are present; "
                         f"on the CPU pass devices=['cpu'] * n")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def state_pspecs(co: CompiledObjective, axis: str = "dp"):
    """The spec tree of `co.pack(...)`: every type stack splits dim 1."""
    return {tk: P(None, axis) for tk in co.type_members}


def aux_pspecs(co: CompiledObjective, axis: str = "dp"):
    """The spec tree of `co.build_aux(...)`: per bucket, (cost aux, weight
    aux); a stacked slot (K, B, ...) splits dim 1, a shared slot (B, ...)
    dim 0."""
    def spec_for(slots):
        return tuple(P(axis) if s.shared else P(None, axis) for s in slots)

    return tuple((spec_for(bk.aux_slots), spec_for(bk.weight_slots)) for bk in co.buckets)


def carry_pspecs(co: CompiledObjective, carry_like, axis: str = "dp"):
    """The spec tree of an optimizer's solve carry: state stacks
    (N_t, B, ...) and the error history (iters + 1, B) split dim 1, the
    state history (iters + 1, N_t, B, ...) dim 2, the iteration counter
    "it" (a Python int) is replicated and every other leaf (B,) splits
    dim 0."""
    specs = {}
    for k, v in carry_like.items():
        if k == "state":
            specs[k] = {tk: P(None, axis) for tk in v}
        elif k == "history":
            specs[k] = P(None, axis)
        elif k == "state_history":
            specs[k] = {tk: P(None, None, axis) for tk in v}
        elif k == "it":
            specs[k] = P()
        else:
            specs[k] = P(axis)
    return specs


def _split(t: torch.Tensor, dim: int, mesh: Mesh) -> List[torch.Tensor]:
    n = len(mesh)
    if t.shape[dim] % n:
        raise ValueError(f"batch dimension {dim} of a {tuple(t.shape)} leaf does not divide into {n} shards")
    return [c.to(d) for c, d in zip(torch.chunk(t, n, dim=dim), mesh.devices)]


def _map_specs(fn, tree, specs):
    """fn(leaf, spec) over a (dict | tuple)-of-tensors tree and its spec
    tree of the same structure."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in specs}
    return tuple(_map_specs(fn, t, s) for t, s in zip(tree, specs))


def _unzip(tree, n: int):
    """A tree whose leaves are n-lists -> n trees."""
    if isinstance(tree, list):
        return tree
    if isinstance(tree, dict):
        per = {k: _unzip(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    per = [_unzip(v, n) for v in tree]
    return [tuple(p[i] for p in per) for i in range(n)]


def shard_problem(co: CompiledObjective, state, aux, mesh: Mesh, axis: str = "dp"):
    """Split state and aux along their batch axis into len(mesh) equal
    shards, shard i on mesh.devices[i]: returns (states, auxes), one state
    dict and one aux tree a shard. Raises when B does not divide. The
    slices and copies are recorded by autograd, so gradients reach the
    unsharded tensors."""
    n = len(mesh)
    split = lambda t, s: _split(t, batch_dim(s, axis), mesh)  # noqa: E731
    states = _unzip(_map_specs(split, state, state_pspecs(co, axis)), n)
    auxes = _unzip(_map_specs(split, aux, aux_pspecs(co, axis)), n)
    return states, auxes


def _on_device(device: torch.device):
    """Make `device` current for a shard's launches (see the module note)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _join_carries(co: CompiledObjective, carries, mesh: Mesh, axis: str = "dp"):
    """The shards' carries as one carry on mesh.home: each leaf concatenated
    along its `carry_pspecs` dimension (`.to()` and `torch.cat`, both
    differentiable). "it" keeps the largest shard count, the count the
    unsharded early-exit solve reaches: it runs until its last element is
    done."""
    specs = carry_pspecs(co, carries[0], axis)

    def join(leaves, spec):
        if isinstance(spec, dict):
            return {k: join([lf[k] for lf in leaves], spec[k]) for k in spec}
        dim = batch_dim(spec, axis)
        if dim is None:
            return max(leaves)
        return torch.cat([lf.to(mesh.home) for lf in leaves], dim=dim)

    return {k: join([c[k] for c in carries], specs[k]) for k in specs}


def shard_map_solve(layer, mesh: Mesh, mode: str = "implicit", opts=None, axis: str = "dp", **solve_kwargs):
    """`solve(states, auxes) -> carry`: `layer.solve_state(state_i, aux_i,
    mode, opts, **solve_kwargs)` on every shard (as `shard_problem` returns
    them), each under `torch.cuda.device(mesh.devices[i])`, in mesh order
    from this thread, then the carries joined on mesh.home
    (`_join_carries`). A `batch_ignore_mask` among solve_kwargs is split
    with the batch. An outer loss on the joined carry differentiates back
    into every shard's aux in each backward mode."""
    co = layer.objective.compile()
    opts = opts or layer.optimizer.opts
    n = len(mesh)
    mask = solve_kwargs.pop("batch_ignore_mask", None)
    masks = [None] * n if mask is None else list(torch.chunk(torch.as_tensor(mask, dtype=torch.bool), n))

    def solve(states, auxes):
        if len(states) != n or len(auxes) != n:
            raise ValueError(f"{len(states)} state shards and {len(auxes)} aux shards for a mesh of {n}")
        carries = []
        for dev, st, ax, m in zip(mesh.devices, states, auxes, masks):
            with _on_device(dev):
                kw = dict(solve_kwargs) if m is None else dict(solve_kwargs, batch_ignore_mask=m)
                carries.append(layer.solve_state(st, ax, mode, opts, **kw))
        return _join_carries(co, carries, mesh, axis)

    return solve


# ---------------------------------------------------------------------------
# GBP: one problem's factors over the mesh
# ---------------------------------------------------------------------------
class _ChunkBuilder:
    """The GBP builder seen through chunked buckets: bucket c of the
    sharded normal is rows `rows` of the original bucket `orig`; everything
    but the variable ids (and the scatter plans made from them) is the
    original builder's."""

    def __init__(self, base, chunks):
        self._base = base
        self.gvars = [[g[rows] for g in base.gvars[orig]] for orig, _, _, rows in chunks]
        self._gbp_dev = {}

    def __getattr__(self, name):
        return getattr(self._base, name)

    gv = GBPNormalBuilder.gv
    scatter_plan = GBPNormalBuilder.scatter_plan


class ShardedGBPNormal(GBPNormal):
    """A GBPNormal whose buckets are split along their factor axis K,
    one chunk a mesh slot, each on its slot's device; buckets whose K
    the mesh does not divide stay whole on the home device. A sweep:
    each chunk scatters its messages into its slot's partial beliefs
    on its device, the partials are summed on the home device (the
    all-reduce XLA inserts in the JAX package: `cross_device_sums`
    counts the arrays so reduced), and every chunk reads the summed
    beliefs back to its device for its cavities."""

    def __init__(self, builder, lams, etas, dtype, bsz, mesh, chunks):
        super().__init__(builder, lams, etas, dtype, bsz)
        self.mesh = mesh
        self.chunks = chunks
        self.device = mesh.home
        self.cross_device_sums = 0

    def _reduce(self, partials):
        """Per-slot partials ({slot: tensor on its device}) summed on home
        in slot order."""
        out = None
        for slot in sorted(partials):
            t = partials[slot].to(self.device)
            out = t if out is None else out + t
        if len(partials) > 1:
            self.cross_device_sums += 1
        return out

    def _scatter(self, base, items):
        """base + the sum over chunks: each chunk adds its items into its
        slot's partial (from zeros, on its device), and the partials meet on
        home (`_reduce`) before base is added, as `GBPNormal._scatter`
        orders its sum."""
        partials = {}
        for c, per_slot in enumerate(items):
            _, slot, dev, _ = self.chunks[c]
            with _on_device(dev):
                acc = partials.get(slot)
                if acc is None:
                    acc = torch.zeros_like(base, device=dev)
                for s, x in enumerate(per_slot):
                    acc = self._add_slot(acc, c, s, x)
            partials[slot] = acc
        return base + self._reduce(partials)

    def quad(self, v):
        bld = self.builder
        vb = bld.unflatten(v)  # (n, B, d) on home
        per_slot = {}
        for c, lam_b in enumerate(self.lams):
            _, slot, dev, _ = self.chunks[c]
            with _on_device(dev):
                vd = vb.to(dev)
                k = len(lam_b)
                out = per_slot.get(slot, 0.0)
                for s in range(k):
                    vs = vd[bld.gv(c, s, dev)]
                    for t in range(s, k):
                        vt = vd[bld.gv(c, t, dev)]
                        term = torch.einsum("kbi,kbij,kbj->b", vs, _blk(lam_b, s, t), vt)
                        out = out + (term if s == t else 2.0 * term)
                per_slot[slot] = out
        return self._reduce(per_slot)

    def _sweep(self, msgs, prior_lam, prior_eta, alpha: float):
        lam_v, eta_v = self._beliefs(msgs, prior_lam, prior_eta)
        on_dev = {}  # the beliefs read back, once a device
        out = []
        for c, bucket in enumerate(msgs):
            dev = self.chunks[c][2]
            key = str(dev)
            if key not in on_dev:
                on_dev[key] = (lam_v.to(dev), eta_v.to(dev))
            with _on_device(dev):
                out.append(self._bucket_messages(c, bucket, *on_dev[key], alpha))
        return tuple(out)


def shard_gbp_factors(normal, mesh: Mesh, axis: str = "factors"):
    """Problem-axis sharding of a GBPNormal: every bucket whose factor count
    K divides len(mesh) is split along K into one chunk a mesh slot, chunk
    i on mesh.devices[i]; any other bucket (the single prior) stays whole
    on the home device, where the JAX package replicates it. Returns a
    `ShardedGBPNormal` whose solve, marginals, diag, quad and Atb work as
    the unsharded normal's; its `cross_device_sums` counts the belief
    reductions across the mesh (`axis` names the mesh axis, as in the JAX
    package; the split itself is the same for any name)."""
    n = len(mesh)
    chunks, lams, etas = [], [], []
    for bi, (lam_b, eta_b) in enumerate(zip(normal.lams, normal.etas)):
        k = eta_b[0].shape[0]
        if k % n == 0:
            step = k // n
            for m, dev in enumerate(mesh.devices):
                rows = slice(m * step, (m + 1) * step)
                lams.append(tuple(tuple(blk[rows].to(dev) for blk in row) for row in lam_b))
                etas.append(tuple(e[rows].to(dev) for e in eta_b))
                chunks.append((bi, m, dev, rows))
        else:
            lams.append(tuple(tuple(blk.to(mesh.home) for blk in row) for row in lam_b))
            etas.append(tuple(e.to(mesh.home) for e in eta_b))
            chunks.append((bi, 0, mesh.home, slice(None)))
    return ShardedGBPNormal(_ChunkBuilder(normal.builder, chunks), tuple(lams), tuple(etas), normal.dtype, normal.bsz,
               mesh, chunks)
