"""Sliding-window patch extraction (unfold) and its adjoint (fold), NHWC.

Counterpart of `autoprog_tpu/ops/unfold.py`. `unfold_nhwc` is k*k strided
slices of the padded input; `fold_nhwc` scatter-adds the same slices back
(the exact linear transpose, so fold and unfold are adjoint as in the JAX
package, where fold is `jax.linear_transpose` of unfold).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _out_hw(H: int, W: int, k: int, s: int, p: int):
    return (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1


def unfold_nhwc(x: torch.Tensor, kernel_size: int, stride: int,
                padding: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, k, k, C], h = (H + 2p - k) // s + 1."""
    B, H, W, C = x.shape
    k, s, p = kernel_size, stride, padding
    h, w = _out_hw(H, W, k, s, p)
    xp = F.pad(x, (0, 0, p, p, p, p))
    rows = []
    for ki in range(k):
        cols = [xp[:, ki:ki + s * (h - 1) + 1:s, kj:kj + s * (w - 1) + 1:s]
                for kj in range(k)]
        rows.append(torch.stack(cols, dim=3))            # [B, h, w, k, C]
    return torch.stack(rows, dim=3)                      # [B, h, w, k, k, C]


def fold_nhwc(patches: torch.Tensor, output_size, kernel_size: int,
              stride: int, padding: int) -> torch.Tensor:
    """Adjoint of `unfold_nhwc`: overlap-add [B, h, w, k, k, C] patches onto
    a [B, H, W, C] canvas (torch `F.fold` semantics)."""
    H, W = output_size
    B, h, w, k, _, C = patches.shape
    s, p = stride, padding
    canvas = patches.new_zeros(B, H + 2 * p, W + 2 * p, C)
    for ki in range(k):
        for kj in range(k):
            canvas[:, ki:ki + s * (h - 1) + 1:s,
                   kj:kj + s * (w - 1) + 1:s] += patches[:, :, :, ki, kj]
    return canvas[:, p:p + H, p:p + W]


def avg_pool_ceil(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(kernel=stride, stride=stride, ceil_mode=True) over NHWC,
    averaging only the in-bounds elements of a ragged edge window."""
    if stride == 1:
        return x
    B, H, W, C = x.shape
    if H % stride == 0 and W % stride == 0:
        return x.reshape(B, H // stride, stride, W // stride, stride,
                         C).mean(dim=(2, 4))
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), stride, stride, ceil_mode=True,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)
