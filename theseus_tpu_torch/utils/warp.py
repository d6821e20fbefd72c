"""Image sampling helpers for direct-alignment residuals (JAX counterpart: theseus_tpu/utils/warp.py).

`bilinear_sample` is written for one image, as the JAX function is: an
`AutoDiffCostFunction` maps it over instances and batch with
torch.func.vmap and differentiates it with jacfwd or jacrev, and plain
autograd takes it to any order (a double backward included). The corner
indices are integers, so no derivative flows through them; the four
corners are gathered with one `index_select` on the flattened image, which
vmap batches.

The coordinate clamp is `torch.maximum(lo, torch.minimum(x, hi))` with
tensor bounds, not `torch.clamp`: at a tie (a sample exactly on the
border, as the pixel grid's own corners are) `jnp.clip` gives the
derivative 1/2, and so do torch.maximum and torch.minimum, in both
autograd modes, where torch.clamp gives 1.
"""

from __future__ import annotations

import torch


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's values and derivatives (1/2 at a tie with a bound)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img (H, W) or (H, W, C); xy (..., 2) in pixel coordinates (x, y).
    Samples with border clamping. Returns (...,) or (..., C)."""
    chan = img.dim() == 3
    h, w = img.shape[0], img.shape[1]
    x = _clip(xy[..., 0], 0.0, w - 1.0)
    y = _clip(xy[..., 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x.detach()).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y.detach()).long(), 0, h - 2)
    wx = x - x0.to(x.dtype)
    wy = y - y0.to(y.dtype)
    if chan:
        wx = wx[..., None]
        wy = wy[..., None]
    flat = img.reshape((h * w,) + tuple(img.shape[2:]))
    base = y0 * w + x0
    # corners in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    idx = torch.stack([base, base + 1, base + w, base + w + 1], dim=0)
    v = torch.index_select(flat, 0, idx.reshape(-1)).reshape(idx.shape + tuple(img.shape[2:]))
    v00, v01, v10, v11 = v.unbind(0)
    return (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11)


def homography_transform(h8: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply the homography whose first 8 entries are h8 (h33 = 1), row
    major: xy (..., N, 2) -> warped (..., N, 2), h8's leading dims
    broadcast against xy's leading dims before the point axis, as in the
    JAX function's einsum. Written elementwise (no matmul) so that mixed
    float dtypes promote."""
    h = h8[..., None, :]
    x, y = xy[..., 0], xy[..., 1]
    qx = h[..., 0] * x + h[..., 1] * y + h[..., 2]
    qy = h[..., 3] * x + h[..., 4] * y + h[..., 5]
    qz = h[..., 6] * x + h[..., 7] * y + 1.0
    return torch.stack([qx / qz, qy / qz], dim=-1)


def image_grid(h: int, w: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """(h*w, 2) pixel coordinates (x, y), x varying fastest."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device), torch.arange(w, dtype=dtype, device=device), indexing="ij"
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
