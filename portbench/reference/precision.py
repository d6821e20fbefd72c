"""The precisions the reference runs in: float64, its own, and those below
the configurations' float32 that control.py reads as controls.

    name        arithmetic  matrix products        storage
    float64     float64     float64                float64
    float32     float32     float32 (TF32 off)     float32
    tf32        float32     TF32                   float32
    bfloat16    float32     float32 (TF32 off)     bfloat16: measurements, poses
                                                   after each step, residuals
                                                   and jacobians
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = {"float64": (torch.float64, None, False), "float32": (torch.float32, None, False),
              "tf32": (torch.float32, None, True), "bfloat16": (torch.float32, torch.bfloat16, False)}


def dtypes(name: str):
    """(arithmetic dtype, storage dtype or None) of precision `name`."""
    dtype, store, _ = PRECISIONS[name]
    return dtype, store


@contextlib.contextmanager
def products(name: str):
    """float32 matrix products in TF32 inside the block where precision
    `name` asks for them, in full float32 otherwise."""
    tf32 = PRECISIONS[name][2]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])
