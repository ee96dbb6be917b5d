"""Image and positional-embedding resizing, NHWC.

Counterpart of `autoprog_tpu/ops/interpolate.py`, which calls
`jax.image.resize(antialias=False)`. That resize is separable: per axis a
weight matrix from a kernel evaluated at half-pixel sample positions,
renormalised per output, applied as a contraction. `_weight_mat` rebuilds
it term for term.

  * `resize_bilinear` (the per-step input downscale) uses
    `F.interpolate(mode="bilinear", align_corners=False, antialias=False)`,
    which computes the same triangle-kernel weights (edge samples clamp in
    torch; the renormalisation gives the same value in JAX) and is one
    fused kernel on the card.
  * `resize_bicubic` (the pos-embed) needs JAX's Keys cubic with a = -0.5.
    torch's bicubic uses a = -0.75 and no renormalisation, so
    `F.interpolate(mode="bicubic")` does not match: the cubic is written out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] cubic weights, as `jax.image.scale.compute_weight_mat`."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NHWC images to (size, size): half-pixel centres,
    no antialiasing."""
    if isinstance(size, int):
        size = (size, size)
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """Bicubic (Keys a = -0.5) resize of a [1, H, W, C] grid, computed in
    f32 and returned in x's dtype."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    wh = _weight_mat(x.shape[1], size[0], x.device)
    ww = _weight_mat(x.shape[2], size[1], x.device)
    y = torch.einsum("bhwc,hi,wj->bijc", x.float(), wh, ww)
    return y.to(x.dtype)
