"""Compiled objective: pure batched residual / jacobian functions over stacked state (JAX counterpart: theseus_tpu/core/compiled.py).

Cost functions are bucketed by schema once; member variables are gathered
from per-type stacked state with static index tables, and each bucket is
evaluated on its whole (K, B, ...) stack at once.

State layout:
  state: {type_key: (N_t, B, *elem_shape)}   one stacked tensor per manifold
  delta: (B, total_dof)                       tangent vector, insertion order
  aux:   tuple over buckets of (cf_aux, w_aux) stacked tensors
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..lie import Group
from .cost_function import CostFunction


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

    @property
    def k(self) -> int:
        return len(self.cfs)

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


def _bcast_batch(v, b: int):
    """(1, ...) -> (b, ...) view, for numpy arrays and tensors alike."""
    if v.shape[0] == b:
        return v
    shape = (b,) + tuple(v.shape[1:])
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
    ):
        self.var_names = tuple(var_names)
        self.var_groups = dict(var_groups)
        self.buckets = tuple(buckets)
        self.type_members = dict(type_members)
        self.aux_defaults = dict(aux_defaults)
        self.dtype = dtype
        self.device = torch.device(device)

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

    def _index(self, arr: np.ndarray, device) -> torch.Tensor:
        """A static numpy index table as a long tensor on `device`, cached so
        that no solve iteration copies tables from the host."""
        key = (id(arr), str(device))
        if key not in self._index_cache:
            self._index_cache[key] = torch.as_tensor(arr, dtype=torch.long, device=device)
        return self._index_cache[key]

    # ------------------------------------------------------------------
    def resolve_batch_size(self, values: Dict[str, object]) -> int:
        """Max leading dim; 1-batches broadcast."""
        b = 1
        for v in values.values():
            if v.ndim > 0:
                b = max(b, int(v.shape[0]))
        return b

    def pack(self, values: Dict[str, object], batch_size: Optional[int] = None):
        """values {name: (B|1, *shape)} -> state {type: (N_t, B, *shape)} on
        the objective's device and dtype."""
        b = batch_size or self.resolve_batch_size(values)
        return {
            tk: _stack([_bcast_batch(values[n], b) for n in members], self.dtype, self.device)
            for tk, members in self.type_members.items()
        }

    def unpack(self, state) -> Dict[str, torch.Tensor]:
        """state -> {name: (B, ...)}."""
        out = {}
        for tk, members in self.type_members.items():
            for i, n in enumerate(members):
                out[n] = state[tk][i]
        return out

    def build_aux(self, values: Dict[str, object], batch_size: Optional[int] = None):
        """Per-bucket stacked aux tensors; floating aux is cast to the
        objective dtype."""
        b = batch_size or self.resolve_batch_size(values)

        def get(n):
            v = values[n] if n in values else self.aux_defaults[n]
            return _bcast_batch(v, b)

        def build_slots(slots):
            out = []
            for s in slots:
                if s.shared:
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

    def _bucket_eval(self, bucket: BucketSpec, state, bucket_aux, mode: str):
        """mode 'metric' -> weighted error (K, B, dim); 'linearize' ->
        (weighted jacobians per slot (K, B, dim, dof), weighted error)."""
        cf_aux, w_aux = bucket_aux
        xs = self.gather_optim(bucket, state)
        template = bucket.template
        weight = template.weight
        if mode == "metric":
            fused = getattr(template, "fused_error", None)
            err = fused(xs, cf_aux) if fused is not None else template.error_impl(xs, cf_aux)
            werr, _ = weight.apply_batched(err, None, w_aux)
            return self._guard_zero_weight_metric(weight, w_aux, werr)
        fused = getattr(template, "fused_linearize", None)
        if fused is not None:
            jacs, err = fused(xs, cf_aux)
        else:
            jacs, err = template.jacobians_impl(xs, cf_aux)
        werr, wjacs = weight.apply_batched(err, list(jacs), w_aux)
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


def compile_objective(objective) -> CompiledObjective:
    """Bucket cost functions by schema and freeze all index arrays."""
    cfs = list(objective.cost_functions.values())
    if not cfs:
        raise ValueError("Objective has no cost functions.")
    for cf in cfs:
        if not cf.has_analytic_jacobians:
            raise NotImplementedError(
                f"{type(cf).__name__} has no analytic jacobians; autodiff costs are not "
                "ported yet (ROADMAP.md, queue 1, slice 3)"
            )

    var_names: List[str] = []
    var_groups: Dict[str, Group] = {}
    aux_defaults = {}
    for cf in cfs:
        for v in cf.optim_vars:
            if v.name not in var_groups:
                var_names.append(v.name)
                var_groups[v.name] = v.group
            elif var_groups[v.name] != v.group:
                raise ValueError(f"Variable {v.name} registered with two groups.")
        for a in list(cf.aux_vars) + list(cf.weight.aux_vars):
            if a.tensor is not None and a.name not in aux_defaults:
                aux_defaults[a.name] = a.tensor

    type_members_l: Dict[str, List[str]] = {}
    for n in var_names:
        type_members_l.setdefault(var_groups[n].name, []).append(n)
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
        key = cf.schema()
        if key not in bucket_map:
            bucket_map[key] = []
            order.append(key)
        bucket_map[key].append(cf)

    buckets: List[BucketSpec] = []
    row_offset = 0
    for key in order:
        members = bucket_map[key]
        t0 = members[0]
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
    )
