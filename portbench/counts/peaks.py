"""The peaks every roofline share divides by.

NVIDIA's published figures for one H100 SXM at its 700 W limit, dense, with
no sparsity: 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s
of HBM3. A card set below 700 W reaches less, so every traced run prints
them beside the card's power limit.
"""

from __future__ import annotations

import subprocess

FLOPS = {"float32": 67e12, "float64": 34e12}
BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / FLOPS[dtype], nbytes / BYTES_PER_S)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def describe() -> str:
    return (f"peaks: {FLOPS['float32'] / 1e12:g} TFLOP/s float32, {BYTES_PER_S / 1e12:g} TB/s HBM "
            f"(H100 SXM, 700 W); card: {card()}")
