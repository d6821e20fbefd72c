"""Objective: the mutable problem-graph builder (JAX counterpart: theseus_tpu/core/objective.py).

The builder keeps the ordered cost functions (and cost families), the
variables and variable families by name; all numerical work lives in the
compiled view (`compile()`), cached until the structure changes. The
objective fixes the dtype and the device every solve runs in: the card
(`config.default_device()`) unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..config import full_precision, resolve_device
from .compiled import CompiledObjective, compile_objective
from .cost_function import CostFunction
from .family import CostFamily, VariableFamily
from .variable import ManifoldVariable, Variable


class Objective:
    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        self.cost_functions: "OrderedDict[str, CostFunction]" = OrderedDict()
        self.optim_vars: Dict[str, ManifoldVariable] = {}
        self.var_families: Dict[str, VariableFamily] = {}
        self.aux_vars: Dict[str, Variable] = {}
        self.dtype = dtype
        self.device = resolve_device(device)
        self._compiled: Optional[CompiledObjective] = None
        # compile(vectorize=...) as last asked explicitly (None: never)
        self._explicit_vectorize: Optional[bool] = None
        self._warned_unvectorized = False

    def _register_optim(self, v: ManifoldVariable):
        fam = getattr(v, "family", None)
        if fam is not None:  # a family member view registers its family
            self.var_families[fam.name] = fam
            return
        existing = self.optim_vars.get(v.name)
        if existing is not None and existing.group != v.group:
            raise ValueError(f"Optim variable name clash with different groups: {v.name}")
        if v.name in self.aux_vars:
            raise ValueError(f"{v.name} already registered as auxiliary.")
        self.optim_vars[v.name] = v

    def add(self, cost_function):
        """Add a CostFunction or a CostFamily (bulk; core/family.py)."""
        if cost_function.name in self.cost_functions:
            raise ValueError(f"Duplicate cost function name {cost_function.name}")
        if isinstance(cost_function, CostFamily):
            for m in cost_function.members:
                if isinstance(m, tuple):
                    self.var_families[m[0].name] = m[0]
                else:
                    self._register_optim(m)
            template = cost_function.template
            aux = list(template.aux_vars) + list(template.weight.aux_vars)
        else:
            for v in cost_function.optim_vars:
                self._register_optim(v)
            aux = list(cost_function.aux_vars) + list(cost_function.weight.aux_vars)
        for a in aux:
            if a.name in self.optim_vars:
                raise ValueError(f"{a.name} already registered as optimization var.")
            self.aux_vars[a.name] = a
        self.cost_functions[cost_function.name] = cost_function
        self._compiled = None
        return self

    def erase(self, name: str):
        """Remove a cost function (or cost family) by name, and every
        variable, variable family and aux variable that no remaining cost
        references. Returns the removed cost."""
        cf = self.cost_functions.pop(name)
        still = set()
        for c in self.cost_functions.values():
            for group in _references(c):
                still.update(group)
        registries = (self.optim_vars, self.var_families, self.aux_vars)
        for registry, names in zip(registries, _references(cf)):
            for n in names:
                if n not in still:
                    registry.pop(n, None)
        self._compiled = None
        return cf

    def has_cost_function(self, name: str) -> bool:
        return name in self.cost_functions

    def get_cost_function(self, name: str) -> Optional[CostFunction]:
        return self.cost_functions.get(name)

    def size_cost_functions(self) -> int:
        return len(self.cost_functions)

    def size_variables(self) -> int:
        return len(self.optim_vars)

    def size_aux_vars(self) -> int:
        return len(self.aux_vars)

    def dim(self) -> int:
        """Rows of the error vector: a cost family counts all its members."""
        return sum(
            cf.total_dim() if isinstance(cf, CostFamily) else cf.dim()
            for cf in self.cost_functions.values()
        )

    def compile(self, vectorize: Optional[bool] = None) -> CompiledObjective:
        """The compiled view. vectorize True buckets costs by schema (the
        default); False gives every cost a bucket of its own (K = 1), the
        ablation of running without vectorization.

        None keeps the last explicit choice, else vectorizes: an explicit
        compile(vectorize=False) is honoured by the calls the optimizer and
        the layer make with no argument (their state and aux are packed for
        that schema), with a one-time UserWarning so that staying
        unvectorized is never silent."""
        if vectorize is not None:
            self._explicit_vectorize = bool(vectorize)
        want = True if self._explicit_vectorize is None else self._explicit_vectorize
        if vectorize is None and not want and not self._warned_unvectorized:
            warnings.warn(
                "reusing an explicitly-requested vectorize=False compilation from the "
                "default path; call compile(vectorize=True) to return to schema-bucketed "
                "vectorization",
                stacklevel=2,
            )
            self._warned_unvectorized = True
        if self._compiled is None or self._compiled.vectorized != want:
            self._compiled = compile_objective(self, vectorize=want)
        return self._compiled

    def default_values(self, input_tensors: Optional[Dict] = None) -> Dict:
        """Merge stored variable defaults with user inputs into a full dict;
        a family's value sits under the family name, (N, B|1, *shape).
        Host arrays stay on the host until pack/build_aux stacks them."""
        values = {}
        for n, v in self.optim_vars.items():
            values[n] = v.default(dtype=self.dtype, device=self.device)
        for n, fam in self.var_families.items():
            values[n] = fam.default(dtype=self.dtype, device=self.device)
        for n, a in self.aux_vars.items():
            if a.tensor is not None:
                values[n] = a.tensor
        for n, t in (input_tensors or {}).items():
            values[n] = t if isinstance(t, (np.ndarray, torch.Tensor)) else np.asarray(t)
        missing = [n for n in self.optim_vars if n not in values or values[n] is None]
        if missing:
            raise ValueError(f"No data for optimization variables {missing}")
        return values

    def _eval_at(self, fn_name: str, values, input_tensors):
        co = self.compile()
        values = values or self.default_values(input_tensors)
        b = co.resolve_batch_size(values)
        state = co.pack(values, b)
        aux = co.build_aux(values, b)
        with full_precision():
            return getattr(co, fn_name)(state, aux)

    def error(self, values: Optional[Dict] = None, input_tensors: Optional[Dict] = None) -> torch.Tensor:
        """Weighted error vector (B, dim()) at `values`, or at
        `default_values(input_tensors)` when values is None."""
        return self._eval_at("error", values, input_tensors)

    def error_metric(self, values: Optional[Dict] = None, input_tensors: Optional[Dict] = None) -> torch.Tensor:
        """0.5 * ||e||^2 per batch element (B,)."""
        return self._eval_at("error_metric", values, input_tensors)


def _references(c):
    """(optim variable names, variable family names, aux names) that the
    cost or cost family c references."""
    if isinstance(c, CostFamily):
        ov = [m.name for m in c.members if not isinstance(m, tuple)]
        fams = [m[0].name for m in c.members if isinstance(m, tuple)]
        aux = list(c.template.aux_vars) + list(c.template.weight.aux_vars)
    else:
        ov = [v.name for v in c.optim_vars]
        fams = [v.family.name for v in c.optim_vars if getattr(v, "family", None) is not None]
        aux = list(c.aux_vars) + list(c.weight.aux_vars)
    return ov, fams, [a.name for a in aux]
