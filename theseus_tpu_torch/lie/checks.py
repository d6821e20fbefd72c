"""Validation contexts for Lie-group inputs (JAX counterpart: theseus_tpu/lie/checks.py).

Off by default, as in the JAX package. When on, a variable checks its
tensor at construction. A check reads the tensor's values, so it is
skipped under a torch.func transform (where the values are not concrete,
as the JAX package skips traced arrays), and on the card it waits for the
device.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

_state = threading.local()


def checks_enabled() -> bool:
    return getattr(_state, "enabled", False)


class set_lie_group_check_enabled:
    """Context manager (or plain call) that turns the checks on or off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prev = checks_enabled()
        _state.enabled = enabled

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _state.enabled = self.prev
        return False


class no_lie_group_check(set_lie_group_check_enabled):
    def __init__(self):
        super().__init__(False)


class enable_checks(set_lie_group_check_enabled):
    def __init__(self):
        super().__init__(True)


enable_lie_group_check = enable_checks


def check_group(group, tensor, atol: Optional[float] = None) -> None:
    """Raise if `tensor` (a torch tensor or a numpy array) is not a valid
    element of `group`; a no-op while the checks are off or under a
    torch.func transform."""
    if not checks_enabled() or torch._C._functorch.peek_interpreter_stack() is not None:
        return
    if not hasattr(group.mod, "check_group_tensor"):
        return
    t = torch.as_tensor(tensor)
    ok = group.mod.check_group_tensor(t) if atol is None else group.mod.check_group_tensor(t, atol)
    ok = np.asarray(ok.cpu())
    if not np.all(ok):
        raise ValueError(
            f"Invalid {group.name} element(s): {int(ok.size - np.count_nonzero(ok))} of {ok.size} "
            "failed the group constraint check."
        )
