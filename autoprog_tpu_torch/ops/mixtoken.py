"""MixToken (token-level CutMix), counterpart of `autoprog_tpu/ops/mixtoken.py`.

The box is drawn on the host from a `torch.Generator` (three scalars per
step, so no device sync). JAX's threefry and torch's Philox never give the
same bits, so the parity tests hand both packages the same box. Under a
process group the batch flip is the global batch's (`parallel/mesh.py:
flip_batch`) and every rank draws the same box.
"""

from __future__ import annotations

import math

import torch

from autoprog_tpu_torch.parallel.mesh import flip_batch


def rand_bbox(gen: torch.Generator, grid_h: int, grid_w: int) -> torch.Tensor:
    """(bbx1, bby1, bbx2, bby2) over a grid_h x grid_w token grid, int32 [4].

    lambda ~ U(0, 1); cut = floor(grid * sqrt(1 - lambda)); a box centred on
    a uniform token, clipped to the grid."""
    lam = torch.rand((), generator=gen).item()
    cut_rat = math.sqrt(1.0 - lam)
    cut_w, cut_h = int(grid_w * cut_rat), int(grid_h * cut_rat)
    cx = int(torch.randint(0, grid_w, (), generator=gen))
    cy = int(torch.randint(0, grid_h, (), generator=gen))
    clip = lambda v, hi: min(max(v, 0), hi)
    return torch.tensor([clip(cx - cut_w // 2, grid_w), clip(cy - cut_h // 2, grid_h),
                         clip(cx + cut_w // 2, grid_w), clip(cy + cut_h // 2, grid_h)],
                        dtype=torch.int32)


def region_mask(bbox: torch.Tensor, grid_h: int, grid_w: int, scale: int = 1,
                device=None) -> torch.Tensor:
    """Boolean [grid_h*scale, grid_w*scale] mask, True inside the box.

    As in the JAX op, bbx (the first coordinate pair) bounds the ROWS and bby
    the columns; the box is in unscaled token units."""
    bbx1, bby1, bbx2, bby2 = (int(v) * scale for v in bbox.tolist())
    rows = torch.arange(grid_h * scale, device=device)[:, None]
    cols = torch.arange(grid_w * scale, device=device)[None, :]
    return (rows >= bbx1) & (rows < bbx2) & (cols >= bby1) & (cols < bby2)


def mix_tokens(x: torch.Tensor, bbox: torch.Tensor, scale: int = 1) -> torch.Tensor:
    """Swap the box region of [B, H, W, C] tokens with the batch-flipped
    tokens."""
    mask = region_mask(bbox, x.shape[1] // scale, x.shape[2] // scale, scale,
                       device=x.device)
    return torch.where(mask[None, :, :, None], flip_batch(x), x)


def unmix_tokens(x: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """Undo the mix on the aux-token grid (the swap is an involution)."""
    return mix_tokens(x, bbox, scale=1)


def mix_lambda(bbox: torch.Tensor, num_tokens: int) -> float:
    """lambda = 1 - box_area / N, as the token-label loss reconstructs it."""
    b = [int(v) for v in bbox.tolist()]
    return 1.0 - float((b[2] - b[0]) * (b[3] - b[1])) / float(num_tokens)
