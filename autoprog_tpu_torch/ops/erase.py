"""The uint8 input pipeline's device half, counterpart of
`autoprog_tpu/ops/erase.py`: normalisation and random erasing (timm
`--remode pixel`) move into the train step when images travel to the device
as uint8 (a quarter of the f32 bytes).

`random_erase` draws every box on the device and applies it with index
masks, so it needs no host sync. The draws and their application are
separate functions (`erase_draws`, `apply_erase`): the tests feed the
second the JAX package's own draws, because torch's Philox and JAX's
threefry give other numbers for one seed. Boxes are clipped to the image
(the host version rejects and redraws instead).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Draw = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
             torch.Tensor]


def normalize_uint8(images: torch.Tensor, mean: Sequence[float], std: Sequence[float],
                    dtype: torch.dtype) -> torch.Tensor:
    """uint8 [B, H, W, C] -> normalised floats of `dtype`."""
    # non_blocking: a blocking copy to the device would wait for the stream
    m = torch.tensor(mean, dtype=torch.float32).to(images.device, non_blocking=True)
    s = torch.tensor(std, dtype=torch.float32).to(images.device, non_blocking=True)
    # a divisor tensor, not a Python scalar: CUDA multiplies by the
    # reciprocal of a scalar divisor, which is not JAX's (nor the CPU's) x / 255
    x = images.float() / torch.full((1,), 255.0, device=images.device)
    return ((x - m) / s).to(dtype)


def erase_draws(generator: torch.Generator, shape, *, prob: float, count: int = 1,
                area: Tuple[float, float] = (0.02, 1 / 3),
                aspect: Tuple[float, float] = (0.3, 10 / 3)) -> List[Draw]:
    """Per box k < count, per image: (do, a, log_r, u_top, u_left, noise):
    whether to erase, the area in pixels, the log aspect ratio, two uniforms
    placing the box, and the N(0, 1) fill of the whole batch shape."""
    B, H, W, _ = shape
    lo, hi = math.log(aspect[0]), math.log(aspect[1])
    draws = []
    for _ in range(count):
        u = torch.rand(5, B, generator=generator, device=generator.device)
        noise = torch.randn(tuple(shape), generator=generator, device=generator.device)
        draws.append((u[0] < prob, (area[0] + (area[1] - area[0]) * u[1]) * (H * W),
                      lo + (hi - lo) * u[2], u[3], u[4], noise))
    return draws


def apply_erase(images: torch.Tensor, draws: Sequence[Draw]) -> torch.Tensor:
    """Fill each drawn box of `images` [B, H, W, C] with its noise."""
    B, H, W, _ = images.shape
    rows = torch.arange(H, device=images.device)[None, :, None]
    cols = torch.arange(W, device=images.device)[None, None, :]
    out = images
    for do, a, log_r, u_top, u_left, noise in draws:
        r = torch.exp(log_r)
        eh = torch.clamp(torch.round(torch.sqrt(a * r)), 1, H).int()
        ew = torch.clamp(torch.round(torch.sqrt(a / r)), 1, W).int()
        top = (u_top * (H - eh + 1).float()).int()[:, None, None]
        left = (u_left * (W - ew + 1).float()).int()[:, None, None]
        inside = ((rows >= top) & (rows < top + eh[:, None, None])
                  & (cols >= left) & (cols < left + ew[:, None, None])
                  & do[:, None, None])
        out = torch.where(inside[..., None], noise.to(out.dtype), out)
    return out


def random_erase(images: torch.Tensor, generator: torch.Generator, *, prob: float,
                 count: int = 1, area: Tuple[float, float] = (0.02, 1 / 3),
                 aspect: Tuple[float, float] = (0.3, 10 / 3)) -> torch.Tensor:
    """Erase `count` random rectangles per image (each with probability
    `prob`) with N(0, 1) pixels; images are normalised NHWC floats."""
    if prob <= 0:
        return images
    return apply_erase(images, erase_draws(generator, images.shape, prob=prob,
                                           count=count, area=area, aspect=aspect))
