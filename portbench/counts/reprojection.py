"""Operations and bytes of one launch of the Reprojection kernel with the
intrinsics optimised (`reprojection_intr_kernel`), from the cell's shapes
alone: each input byte read once, each output byte written once.

Per observation and batch element it reads the pose (12 values), the point
(3), the intrinsics f, k1, k2 (3) and the feature (2), and writes jpose
(2 x 6), jpt (2 x 3), jintr (2 x 3) and the residual (2): 46 values, 184
bytes in float32. Operations, a hand count of csrc/reprojection.cu: the
transform 18, the projection and its radius 6, the distortion factor and
its derivative 9, de/dproj 12, dproj/dP 5, de/dP 18, jpt 30, the pose's
rotation block 30, the residual 4, jintr 13: about 145, rounded up to 150.
"""

from __future__ import annotations

INTR_IN, INTR_OUT, INTR_FLOPS = 20, 26, 150


def reprojection_intr(shapes, itemsize: int):
    n = shapes["n_obs"] * shapes["batch"]
    return INTR_FLOPS * n, (INTR_IN + INTR_OUT) * n * itemsize
