"""Checkpoint and resume helpers (JAX counterpart: theseus_tpu/utils/checkpoint.py).

The files are numpy `.npz` archives in the JAX package's layout, so a
file either package writes loads in the other: `save_values` stores one
array per name; `save_pytree` stores the leaves as "leaf_<i>" in the JAX
package's leaf order (dict keys sorted, OrderedDict and namedtuple fields
in their order, lists and tuples in order, None no leaf) beside a
"__treedef__" description that loading does not read. `load_pytree` puts
the leaves back into the structure of `like` (nested dicts, lists,
tuples, namedtuples, a `state_dict`); a different number of leaves
raises ValueError, as the JAX package's tree_unflatten does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import resolve_device


def _path(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_values(path, values: Dict[str, Any]) -> None:
    """Save a flat {name: tensor} dict (an objective's values, learned
    parameters)."""
    np.savez(path, **{k: _numpy(v) for k, v in values.items()})


def load_values(path, dtype: torch.dtype = None, device=None) -> Dict[str, torch.Tensor]:
    """The dict `save_values` wrote (either package's), as tensors on
    `device` (None: the card), cast to `dtype` when given."""
    device = resolve_device(device)
    with np.load(_path(path)) as data:
        return {k: torch.as_tensor(data[k], device=device, dtype=dtype) for k in data.files}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _keys(d) -> List:
    return list(d.keys()) if isinstance(d, OrderedDict) else sorted(d.keys())


def _flatten(tree, out: List) -> str:
    """Append tree's leaves to out in the JAX package's order; returns a
    description of the structure."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_flatten(tree[k], out)}" for k in _keys(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(v, out) for v in tree)
        name = type(tree).__name__ if _is_namedtuple(tree) else ("[]" if isinstance(tree, list) else "()")
        return f"{name}({inner})"
    out.append(tree)
    return "*"


def _unflatten(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in _keys(like)}
        return type(like)((k, vals[k]) for k in like.keys())
    if _is_namedtuple(like):
        return type(like)(*[_unflatten(v, leaves) for v in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def save_pytree(path, tree: Any) -> None:
    """Save a nested structure of tensors (a solve carry, an optimizer's
    info, a module's state_dict)."""
    leaves: List = []
    desc = _flatten(tree, leaves)
    np.savez(path, __treedef__=np.frombuffer(desc.encode(), dtype=np.uint8),
             **{f"leaf_{i}": _numpy(v) for i, v in enumerate(leaves)})


def load_pytree(path, like: Any, device=None) -> Any:
    """The leaves `save_pytree` wrote (either package's), as tensors on
    `device` (None: the card), in the structure of `like`."""
    device = resolve_device(device)
    with np.load(_path(path)) as data:
        n = len([f for f in data.files if f.startswith("leaf_")])
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device) for i in range(n)]
    expected: List = []
    _flatten(like, expected)
    if len(expected) != n:
        raise ValueError(f"the file holds {n} leaves and the structure of `like` has {len(expected)}")
    return _unflatten(like, iter(leaves))
