"""Shared helpers for the functional Lie layer (JAX counterpart: theseus_tpu/lie/utils.py).

Every op accepts arbitrary leading batch dimensions through plain torch
broadcasting. `nz` substitutes a harmless non-zero value into masked
denominators so that `torch.where` branches never divide by zero.
"""

from __future__ import annotations

import torch

# Dummy non-zero value substituted inside guarded `where` denominators.
NON_ZERO = 1.0


def nz(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace masked entries with a harmless non-zero value."""
    return torch.where(mask, torch.full_like(x, NON_ZERO), x)


def so3_hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    zero = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def antisym_project(m: torch.Tensor) -> torch.Tensor:
    """vee of the antisymmetric part: (..., 3, 3) -> (..., 3)."""
    return 0.5 * torch.stack(
        [
            m[..., 2, 1] - m[..., 1, 2],
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 1, 0] - m[..., 0, 1],
        ],
        dim=-1,
    )


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n), (..., m) -> (..., n, m)."""
    return a[..., :, None] * b[..., None, :]


def mvp(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., n, m) @ (..., m) -> (..., n)."""
    return (m @ v[..., None])[..., 0]


def transpose(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def draw(normal: bool, shape, generator, dtype: torch.dtype, device) -> torch.Tensor:
    """Standard normal (`normal`) or uniform [0, 1) numbers of `shape`.

    With a `generator` they are drawn on the generator's own device and then
    moved to `device`, so one CPU generator gives the same numbers whatever
    the target device; without one, on `device` from its default
    generator."""
    fn = torch.randn if normal else torch.rand
    if generator is None:
        return fn(tuple(shape), dtype=dtype, device=device)
    return fn(tuple(shape), generator=generator, dtype=dtype, device=generator.device).to(device)
