"""Objective: the mutable problem-graph builder (JAX counterpart: theseus_tpu/core/objective.py).

The builder keeps the ordered cost functions (and cost families), the
variables and variable families by name; all numerical work lives in the
compiled view (`compile()`), cached until the structure changes. The
objective fixes the dtype and the device every solve runs in: the card
(`config.default_device()`) unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..config import resolve_device
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

    def compile(self) -> CompiledObjective:
        if self._compiled is None:
            self._compiled = compile_objective(self)
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
