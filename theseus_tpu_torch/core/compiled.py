"""Compiled objective: pure batched residual / jacobian functions over stacked state (JAX counterpart: theseus_tpu/core/compiled.py).

Cost functions are bucketed by schema once; member variables are gathered
from per-type stacked state with static index tables, and each bucket is
evaluated on its whole (K, B, ...) stack at once.

State layout:
  state: {type_key: (N_t, B, *elem_shape)}   one stacked tensor per manifold
  delta: (B, total_dof)                       tangent vector, insertion order
  aux:   tuple over buckets of (cf_aux, w_aux) stacked tensors

A variable family (core/family.py) enters its type stack as one contiguous
run and its values as one (N, B, ...) array; a cost family becomes one
bucket whose index tables are built vectorized and whose aux arrays arrive
pre-stacked.

A cost without analytic jacobians (`AutoDiffCostFunction`, or any
`CostFunction` that leaves `jacobians_impl` out) is written for one instance
and one batch element, as in the JAX package: its bucket maps the error
function, or its autodiff jacobians (`CostFunction.jacobians_fn`), with
`torch.func.vmap` over the K instances (shared aux slots unmapped) and the
batch, as the JAX compiler does with jax.vmap.

`dense_A_b` places every bucket's jacobian blocks into one dense (B, M, D)
matrix for the dense linearization.

A robust bucket (`RobustCostFunction`, `GNCRobustCostFunction`) evaluates
the wrapped cost as any bucket does, through its fused linearization where
it has one, then applies the weight, then the robust loss: in metric mode
`robust_apply_error`, in linearize mode the sqrt(rho') rescale of the
weighted error and jacobians, a plain elementwise torch pass. Here the route
differs from the JAX package, which skips its fused Pallas kernel for robust
buckets (the kernel returns unweighted outputs that would bypass the
transform) and vmaps the cost's jacobians function instead: the values are
the same function, and the robust bundle-adjustment path still runs the
Reprojection kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lie import Group
from .cost_function import CostFunction, GNCRobustCostFunction, RobustCostFunction


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    type_key: str
    dof: int
    idx: np.ndarray  # (K,) member index within the type stack
    cols: np.ndarray  # (K, dof) global tangent column indices
    shared: bool  # all instances reference the same variable


@dataclasses.dataclass(frozen=True)
class AuxSlotSpec:
    names: Tuple[str, ...]
    shared: bool
    # stacked=True: the single name refers to a pre-stacked (K, B|1, ...)
    # array (the CostFamily bulk path): no per-member stack at build_aux
    stacked: bool = False


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    name: str
    template: CostFunction
    cfs: Tuple[CostFunction, ...]
    dim: int
    row_offset: int
    optim_slots: Tuple[SlotSpec, ...]
    aux_slots: Tuple[AuxSlotSpec, ...]
    weight_slots: Tuple[AuxSlotSpec, ...]
    # CostFamily buckets carry no per-member cfs; their count is explicit
    count: Optional[int] = None

    @property
    def robust(self) -> bool:
        return isinstance(self.template, RobustCostFunction)

    @property
    def gnc(self) -> bool:
        return isinstance(self.template, GNCRobustCostFunction)

    @property
    def k(self) -> int:
        return self.count if self.count is not None else len(self.cfs)

    @property
    def rows(self) -> int:
        return self.k * self.dim


def _stack(arrs, dtype: torch.dtype, device) -> torch.Tensor:
    """Stack along a new axis 0 and move to (device, dtype). All-numpy inputs
    stack on the host and cross to the device in one copy."""
    if all(isinstance(a, np.ndarray) for a in arrs):
        return torch.as_tensor(np.stack(arrs), dtype=dtype, device=device)
    return torch.stack([_to(a, dtype, device) for a in arrs])


def _to(v, dtype: torch.dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    a = np.ascontiguousarray(v)
    if not a.flags.writeable:  # torch.as_tensor needs a writable buffer
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def _bcast_batch(v, b: int, axis: int = 0):
    """Batch axis `axis` of size 1 -> b, a view, for numpy arrays and tensors
    alike (axis 1 for the (N, B, ...) arrays of families and stacked aux)."""
    if v.ndim <= axis or v.shape[axis] == b:
        return v
    shape = tuple(v.shape[:axis]) + (b,) + tuple(v.shape[axis + 1:])
    return np.broadcast_to(v, shape) if isinstance(v, np.ndarray) else v.expand(shape)


class CompiledObjective:
    """Pure-function view of an Objective. All index arrays are static."""

    def __init__(
        self,
        var_names: Sequence[str],
        var_groups: Dict[str, Group],
        buckets: Sequence[BucketSpec],
        type_members: Dict[str, Tuple[str, ...]],
        aux_defaults: Dict[str, object],
        dtype: torch.dtype,
        device: torch.device,
        type_segments: Optional[Dict[str, list]] = None,
        families: Sequence[str] = (),
        vectorized: bool = True,
    ):
        self.vectorized = vectorized
        self.var_names = tuple(var_names)
        self.var_groups = dict(var_groups)
        self.buckets = tuple(buckets)
        self.type_members = dict(type_members)
        self.aux_defaults = dict(aux_defaults)
        self.dtype = dtype
        self.device = torch.device(device)
        # per type, runs of ("vars", [names]) | ("fam", family) in stack order
        self.type_segments = type_segments or {
            tk: [("vars", list(members))] for tk, members in self.type_members.items()
        }
        # names whose values are (N, B, ...) stacked, batch at axis 1
        self.stacked_names = set(families)
        for bk in self.buckets:
            for s in bk.aux_slots + bk.weight_slots:
                if s.stacked:
                    self.stacked_names.add(s.names[0])

        self.col_offset: Dict[str, int] = {}
        off = 0
        for n in self.var_names:
            self.col_offset[n] = off
            off += self.var_groups[n].dof
        self.total_dof = off
        self.total_dim = sum(b.rows for b in self.buckets)

        self.groups_by_type: Dict[str, Group] = {}
        for n in self.var_names:
            self.groups_by_type[self.var_groups[n].name] = self.var_groups[n]
        self.type_cols: Dict[str, np.ndarray] = {}
        for tk, members in self.type_members.items():
            g = self.groups_by_type[tk]
            self.type_cols[tk] = np.stack(
                [np.arange(self.col_offset[n], self.col_offset[n] + g.dof) for n in members]
            )
        self._index_cache: Dict[Tuple[int, str], torch.Tensor] = {}
        self._dense = None  # dense_A_b's tables, built on first use
        self._raw = None  # flatten_raw's column tables, built on first use

    def _index(self, arr: np.ndarray, device) -> torch.Tensor:
        """A static numpy index table as a long tensor on `device`, cached so
        that no solve iteration copies tables from the host."""
        key = (id(arr), str(device))
        if key not in self._index_cache:
            self._index_cache[key] = torch.as_tensor(arr, dtype=torch.long, device=device)
        return self._index_cache[key]

    # ------------------------------------------------------------------
    def resolve_batch_size(self, values: Dict[str, object]) -> int:
        """Max batch dim; 1-batches broadcast. Family and stacked-aux values
        carry the batch at axis 1."""
        b = 1
        for k, v in values.items():
            ax = 1 if k in self.stacked_names else 0
            if v.ndim > ax:
                b = max(b, int(v.shape[ax]))
        return b

    def pack(self, values: Dict[str, object], batch_size: Optional[int] = None):
        """values {name: (B|1, *shape)} and {family: (N, B|1, *shape)} ->
        state {type: (N_t, B, *shape)} on the objective's device and dtype.
        A family enters as one operand, never as N."""
        b = batch_size or self.resolve_batch_size(values)
        state = {}
        for tk, segs in self.type_segments.items():
            pieces = []
            for kind, obj in segs:
                if kind == "vars":
                    pieces.append(_stack([_bcast_batch(values[n], b) for n in obj],
                                         self.dtype, self.device))
                else:
                    v = _bcast_batch(values[obj.name], b, axis=1)
                    pieces.append(_to(v, self.dtype, self.device).contiguous())
            state[tk] = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        return state

    def unpack(self, state) -> Dict[str, torch.Tensor]:
        """state -> {name: (B, ...)} and {family: (N, B, ...)}."""
        out = {}
        for tk, segs in self.type_segments.items():
            off = 0
            for kind, obj in segs:
                if kind == "vars":
                    for n in obj:
                        out[n] = state[tk][off]
                        off += 1
                else:
                    out[obj.name] = state[tk][off : off + obj.count]
                    off += obj.count
        return out

    def build_aux(self, values: Dict[str, object], batch_size: Optional[int] = None):
        """Per-bucket stacked aux tensors; floating aux is cast to the
        objective dtype. A stacked slot (cost family) moves its one
        (K, B|1, ...) array to the device in one copy."""
        b = batch_size or self.resolve_batch_size(values)

        def get(n, axis=0):
            v = values[n] if n in values else self.aux_defaults[n]
            return _bcast_batch(v, b, axis)

        def build_slots(slots):
            out = []
            for s in slots:
                if s.stacked:
                    out.append(_to(get(s.names[0], axis=1), self.dtype, self.device))
                elif s.shared:
                    out.append(_to(get(s.names[0]), self.dtype, self.device))
                else:
                    out.append(_stack([get(n) for n in s.names], self.dtype, self.device))
            return tuple(out)

        return tuple(
            (build_slots(bk.aux_slots), build_slots(bk.weight_slots)) for bk in self.buckets
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _mask_zero_weights(weight, w_aux, werr, wjacs=None):
        """A zero weight contributes exactly 0 to the linearization, even for
        a NaN/inf residual."""
        zmask = weight.is_zero(w_aux)
        if zmask is None:
            return werr, wjacs
        werr = torch.where(zmask[..., None], torch.zeros_like(werr), werr)
        if wjacs is not None:
            wjacs = [torch.where(zmask[..., None, None], torch.zeros_like(j), j) for j in wjacs]
        return werr, wjacs

    @staticmethod
    def _guard_zero_weight_metric(weight, w_aux, werr):
        """Metric path: zero only entries that are both zero-weight and
        non-finite."""
        zmask = weight.is_zero(w_aux)
        if zmask is None:
            return werr
        bad = zmask[..., None] & ~torch.isfinite(werr)
        return torch.where(bad, torch.zeros_like(werr), werr)

    def gather_optim(self, bucket: BucketSpec, state):
        """The bucket's optim operands, one (K, B, *shape) stack per slot."""
        return tuple(
            state[s.type_key][self._index(s.idx, state[s.type_key].device)]
            for s in bucket.optim_slots
        )

    @staticmethod
    def _map_instances(bucket: BucketSpec, fn, xs, cost_aux):
        """A per-instance, per-batch-element fn(optim, aux) over the stacked
        (K, B, ...) operands: vmap over K (a shared aux slot, (B, ...),
        unmapped), then over B."""
        n = len(xs)

        def one(*args):
            return fn(tuple(args[:n]), tuple(args[n:]))

        k_dims = (0,) * n + tuple(None if s.shared else 0 for s in bucket.aux_slots[: len(cost_aux)])
        return torch.func.vmap(torch.func.vmap(one), in_dims=k_dims)(*xs, *cost_aux)

    def _bucket_eval(self, bucket: BucketSpec, state, bucket_aux, mode: str):
        """mode 'metric' -> weighted error (K, B, dim); 'linearize' ->
        (weighted jacobians per slot (K, B, dim, dof), weighted error)."""
        cf_aux, w_aux = bucket_aux
        xs = self.gather_optim(bucket, state)
        template = bucket.template
        weight = template.weight
        cost, cost_aux = template, cf_aux
        if bucket.robust:  # aux: the wrapped cost's, log radius (, mu)
            cost, cost_aux = template.cost_function, template.inner_aux(cf_aux)
            log_radius = cf_aux[len(cost_aux)][..., 0]  # (K, B) or shared (B,)
            mu = cf_aux[-1][..., 0] if bucket.gnc else None
        per_instance = not cost.has_analytic_jacobians
        if mode == "metric":
            fused = getattr(cost, "fused_error", None)
            if per_instance:
                err = self._map_instances(bucket, cost.error_impl, xs, cost_aux)
            elif fused is not None:
                err = fused(xs, cost_aux)
            else:
                err = cost.error_impl(xs, cost_aux)
            werr, _ = weight.apply_batched(err, None, w_aux)
            if bucket.robust:
                werr = template.robust_apply_error(werr, log_radius, mu)
            return self._guard_zero_weight_metric(weight, w_aux, werr)
        fused = getattr(cost, "fused_linearize", None)
        if per_instance:
            jacs, err = self._map_instances(bucket, cost.jacobians_fn(), xs, cost_aux)
        elif fused is not None:
            jacs, err = fused(xs, cost_aux)
        else:
            jacs, err = cost.jacobians_impl(xs, cost_aux)
        werr, wjacs = weight.apply_batched(err, list(jacs), w_aux)
        if bucket.robust:
            scale = template.robust_rescale(werr, log_radius, mu)
            scale = scale if template.flatten_dims else scale[..., None]
            werr = scale * werr
            wjacs = [scale[..., None] * j for j in wjacs]
        werr, wjacs = self._mask_zero_weights(weight, w_aux, werr, wjacs)
        return tuple(wjacs), werr

    def error(self, state, aux, mode: str = "metric"):
        """Weighted error vector (B, total_dim)."""
        outs = []
        for bk, bk_aux in zip(self.buckets, aux):
            if mode == "metric":
                werr = self._bucket_eval(bk, state, bk_aux, "metric")
            else:
                _, werr = self._bucket_eval(bk, state, bk_aux, "linearize")
            outs.append(werr.movedim(0, 1).reshape(werr.shape[1], -1))
        return torch.cat(outs, dim=-1)

    def error_metric(self, state, aux):
        """0.5 * ||e||^2 per batch element."""
        e = self.error(state, aux, mode="metric")
        return 0.5 * torch.sum(e * e, dim=-1)

    def linearize_blocks(self, state, aux):
        """Per-bucket ((jacs per slot (K,B,dim,dof)), err (K,B,dim))."""
        return [
            self._bucket_eval(bk, state, bk_aux, "linearize")
            for bk, bk_aux in zip(self.buckets, aux)
        ]

    def _dense_tables(self):
        """Static tables of `dense_A_b`: the flat (row * D + column) position
        in A of every bucket's jacobian entries, in (bucket, K, dim, slot
        columns) order, no position twice; and per bucket, per slot, the
        (other slot, (K,) mask) pairs that name the same variable."""
        if self._dense is None:
            pos, repeats = [], []
            for bk in self.buckets:
                rows = bk.row_offset + np.arange(bk.rows).reshape(bk.k, bk.dim)
                cols = np.concatenate([s.cols for s in bk.optim_slots], axis=1)  # (K, S)
                pos.append((rows[:, :, None] * self.total_dof + cols[:, None, :]).reshape(-1))
                slots = bk.optim_slots
                repeats.append([
                    [(j, (a.idx == b.idx).astype(np.int64)) for j, b in enumerate(slots)
                     if j != i and a.type_key == b.type_key and bool(np.any(a.idx == b.idx))]
                    for i, a in enumerate(slots)
                ])
            self._dense = (np.concatenate(pos), repeats)
        return self._dense

    def _sum_repeated_slots(self, repeats, jacs):
        """A cost that names one variable in two slots writes one block of A
        twice: give each such slot the sum, in slot order, of the slots that
        share its variable, so every write carries the same bits and a plain
        scatter places the sum."""
        out = []
        for i, partners in enumerate(repeats):
            if not partners:
                out.append(jacs[i])
                continue
            masks = dict(partners)
            total = None
            for t, jac in enumerate(jacs):
                if t != i and t not in masks:
                    continue
                if t != i:
                    m = self._index(masks[t], jac.device).bool().reshape(-1, 1, 1, 1)
                    jac = torch.where(m, jac, torch.zeros_like(jac))
                total = jac if total is None else total + jac
            out.append(total)
        return out

    def dense_A_b(self, state, aux):
        """The batched dense jacobian A (B, M, D) and b = -err (B, M), with
        M = total_dim and D = total_dof: one scatter of unique positions (no
        atomics, so the same bits on every run)."""
        pos, repeats = self._dense_tables()
        some = next(iter(state.values()))
        bsz = some.shape[1]
        vals, errs = [], []
        for rep, (jacs, werr) in zip(repeats, self.linearize_blocks(state, aux)):
            jac = torch.cat(self._sum_repeated_slots(rep, jacs), dim=-1)  # (K, B, dim, S)
            vals.append(jac.movedim(1, 0).reshape(bsz, -1))
            errs.append(werr.movedim(0, 1).reshape(bsz, -1))
        flat = torch.zeros((bsz, self.total_dim * self.total_dof), dtype=some.dtype, device=some.device)
        flat = flat.index_copy(1, self._index(pos, some.device), torch.cat(vals, dim=1))
        return flat.reshape(bsz, self.total_dim, self.total_dof), -torch.cat(errs, dim=-1)

    # ------------------------------------------------------------------
    def retract(self, state, delta, accept=None):
        """state + delta (B, D), optionally masked per batch element
        (accept (B,) bool; False freezes that element)."""
        new_state = {}
        for tk in self.type_members:
            g = self.groups_by_type[tk]
            cols = self._index(self.type_cols[tk], delta.device)  # (N_t, dof)
            d = delta[:, cols].movedim(0, 1)  # (N_t, B, dof)
            cur = state[tk]
            new = g.retract(cur, d)
            if accept is not None:
                mask = accept.reshape((1, -1) + (1,) * (new.dim() - 2))
                new = torch.where(mask, new, cur)
            new_state[tk] = new
        return new_state

    def state_dtype(self, state):
        return next(iter(state.values())).dtype

    def batch_size(self, state):
        return next(iter(state.values())).shape[1]

    # -- raw-coordinate flattening (for sampling-based optimizers) -------
    @property
    def total_raw_dim(self) -> int:
        return sum(int(np.prod(self.var_groups[n].shape)) for n in self.var_names)

    def _raw_tables(self):
        """The type-major layout (each type's stack (N_t, *shape) flattened,
        types in type_members order) against the raw layout (variables in
        insertion order): `perm` takes type-major to raw, `inv` back."""
        if self._raw is None:
            start, off = {}, 0
            for tk, members in self.type_members.items():
                size = int(np.prod(self.groups_by_type[tk].shape))
                for i, n in enumerate(members):
                    start[n] = off + i * size
                off += len(members) * size
            perm = np.concatenate([start[n] + np.arange(int(np.prod(self.var_groups[n].shape)))
                                   for n in self.var_names])
            self._raw = (perm, np.argsort(perm))
        return self._raw

    def flatten_raw(self, state):
        """state -> (B, total_raw_dim), variables in insertion order."""
        b = self.batch_size(state)
        perm, _ = self._raw_tables()
        flat = torch.cat([state[tk].movedim(0, 1).reshape(b, -1) for tk in self.type_members], dim=1)
        return flat[:, self._index(perm, flat.device)]

    def unflatten_raw(self, vec):
        """(B, total_raw_dim) -> state (no manifold projection applied)."""
        b = vec.shape[0]
        _, inv = self._raw_tables()
        flat = vec[:, self._index(inv, vec.device)]
        state, off = {}, 0
        for tk, members in self.type_members.items():
            shape = tuple(self.groups_by_type[tk].shape)
            size = len(members) * int(np.prod(shape))
            state[tk] = flat[:, off:off + size].reshape((b, len(members)) + shape).movedim(1, 0)
            off += size
        return state

    def repeat_aux(self, aux, n: int):
        """aux with every leaf's batch axis repeated n times, sample-major
        (batch s * B + b): n states stacked on the batch axis evaluate
        against it in one call."""
        def rep(slots, leaves):
            out = []
            for s, a in zip(slots, leaves):
                axis = 0 if (s.shared and not s.stacked) else 1
                out.append(a if a.dim() <= axis else a.repeat(*[n if i == axis else 1 for i in range(a.dim())]))
            return tuple(out)

        return tuple((rep(bk.aux_slots, cf), rep(bk.weight_slots, w)) for bk, (cf, w) in zip(self.buckets, aux))


def _family_bucket(fam_cf, bucket_i: int, row_offset: int, type_index, col_offset) -> BucketSpec:
    """One BucketSpec from a CostFamily, its index tables built vectorized."""
    template = fam_cf.template
    count = fam_cf.count
    optim_slots = []
    for m in fam_cf.members:
        if isinstance(m, tuple):
            fam, idx = m
            g = fam.group
            sidx = type_index[fam.member_name(0)] + idx
            cols = col_offset[fam.member_name(0)] + idx[:, None] * g.dof + np.arange(g.dof)[None, :]
            shared = False
        else:
            g = m.group
            sidx = np.full(count, type_index[m.name], dtype=np.int64)
            cols = np.broadcast_to(col_offset[m.name] + np.arange(g.dof)[None, :], (count, g.dof)).copy()
            shared = True
        optim_slots.append(SlotSpec(type_key=g.name, dof=g.dof, idx=sidx, cols=cols, shared=shared))

    def slots_for(avars):
        out = []
        for a in avars:
            stacked = fam_cf.aux_is_stacked(a)
            out.append(AuxSlotSpec(names=(a.name,), shared=not stacked, stacked=stacked))
        return tuple(out)

    return BucketSpec(
        name=f"bucket_{bucket_i}_{fam_cf.name}",
        template=template,
        cfs=(),
        count=count,
        dim=template.dim(),
        row_offset=row_offset,
        optim_slots=tuple(optim_slots),
        aux_slots=slots_for(template.aux_vars),
        weight_slots=slots_for(template.weight.aux_vars),
    )


def compile_objective(objective, vectorize: bool = True) -> CompiledObjective:
    """Bucket cost functions by schema and freeze all index arrays. A
    CostFamily is always a bucket of its own.

    vectorize=False gives every cost function a bucket of its own (K = 1),
    the ablation of running without vectorization: the same values, one
    evaluation (and on the card one kernel launch) per cost."""
    from .family import CostFamily, VariableFamily

    cfs = list(objective.cost_functions.values())
    if not cfs:
        raise ValueError("Objective has no cost functions.")
    # optim var registry in insertion order; a family registers as one
    # contiguous run of its members
    var_entries: List[Tuple[str, object]] = []  # ("var", name) | ("fam", family)
    var_groups: Dict[str, Group] = {}
    families: Dict[str, VariableFamily] = {}
    aux_defaults = {}

    def reg_family(fam: VariableFamily):
        if fam.name in families:
            return
        if fam.name in var_groups:
            raise ValueError(f"Name clash: {fam.name} is already a variable.")
        families[fam.name] = fam
        var_entries.append(("fam", fam))
        for i in range(fam.count):
            var_groups[fam.member_name(i)] = fam.group

    def reg_var(v):
        fam = getattr(v, "family", None)
        if fam is not None:
            reg_family(fam)
        elif v.name not in var_groups:
            var_entries.append(("var", v.name))
            var_groups[v.name] = v.group
        elif var_groups[v.name] != v.group:
            raise ValueError(f"Variable {v.name} registered with two groups.")

    def reg_aux(avars):
        for a in avars:
            if a.tensor is not None and a.name not in aux_defaults:
                aux_defaults[a.name] = a.tensor

    for cf in cfs:
        if isinstance(cf, CostFamily):
            for m in cf.members:
                if isinstance(m, tuple):
                    reg_family(m[0])
                else:
                    reg_var(m)
            reg_aux(list(cf.template.aux_vars) + list(cf.template.weight.aux_vars))
        else:
            for v in cf.optim_vars:
                reg_var(v)
            reg_aux(list(cf.aux_vars) + list(cf.weight.aux_vars))

    # member names in tangent-layout order, and per type the runs of single
    # vars and family blocks that make up its stack
    var_names: List[str] = []
    type_segments: Dict[str, list] = {}
    type_members_l: Dict[str, List[str]] = {}
    for kind, obj in var_entries:
        if kind == "var":
            names = [obj]
            tk = var_groups[obj].name
            segs = type_segments.setdefault(tk, [])
            if segs and segs[-1][0] == "vars":
                segs[-1][1].append(obj)
            else:
                segs.append(("vars", [obj]))
        else:
            names = [obj.member_name(i) for i in range(obj.count)]
            tk = obj.group.name
            type_segments.setdefault(tk, []).append(("fam", obj))
        var_names.extend(names)
        type_members_l.setdefault(tk, []).extend(names)
    type_members = {tk: tuple(ms) for tk, ms in type_members_l.items()}
    type_index = {n: i for ms in type_members.values() for i, n in enumerate(ms)}

    col_offset = {}
    off = 0
    for n in var_names:
        col_offset[n] = off
        off += var_groups[n].dof

    # schema bucketing, preserving insertion order of first member
    bucket_map: Dict = {}
    order: List = []
    for cf in cfs:
        if isinstance(cf, CostFamily):
            key = ("__family__", cf.name)
        else:
            key = cf.schema() if vectorize else (cf.schema(), cf.name)
        if key not in bucket_map:
            bucket_map[key] = []
            order.append(key)
        bucket_map[key].append(cf)

    buckets: List[BucketSpec] = []
    row_offset = 0
    for key in order:
        members = bucket_map[key]
        t0 = members[0]
        if isinstance(t0, CostFamily):
            bk = _family_bucket(t0, len(buckets), row_offset, type_index, col_offset)
            buckets.append(bk)
            row_offset += bk.rows
            continue
        optim_slots = []
        for si, v in enumerate(t0.optim_vars):
            g = v.group
            names = [cf.optim_vars[si].name for cf in members]
            optim_slots.append(
                SlotSpec(
                    type_key=g.name,
                    dof=g.dof,
                    idx=np.array([type_index[n] for n in names]),
                    cols=np.stack(
                        [np.arange(col_offset[n], col_offset[n] + g.dof) for n in names]
                    ),
                    shared=len(set(names)) == 1,
                )
            )
        aux_slots = []
        for si in range(len(t0.aux_vars)):
            names = tuple(cf.aux_vars[si].name for cf in members)
            aux_slots.append(AuxSlotSpec(names=names, shared=len(set(names)) == 1))
        weight_slots = []
        for si in range(len(t0.weight.aux_vars)):
            names = tuple(cf.weight.aux_vars[si].name for cf in members)
            weight_slots.append(AuxSlotSpec(names=names, shared=len(set(names)) == 1))
        buckets.append(
            BucketSpec(
                name=f"bucket_{len(buckets)}_{type(t0).__name__}",
                template=t0,
                cfs=tuple(members),
                dim=t0.dim(),
                row_offset=row_offset,
                optim_slots=tuple(optim_slots),
                aux_slots=tuple(aux_slots),
                weight_slots=tuple(weight_slots),
            )
        )
        row_offset += len(members) * t0.dim()

    return CompiledObjective(
        var_names=var_names,
        var_groups=var_groups,
        buckets=buckets,
        type_members=type_members,
        aux_defaults=aux_defaults,
        dtype=objective.dtype,
        device=objective.device,
        type_segments=type_segments,
        families=families,
        vectorized=vectorize,
    )
