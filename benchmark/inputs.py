"""What the benchmark makes from `--seed` and hands to both sides: the
weights and the batches. Same seed, same device type: same values.

Weights are drawn on the device in one call per configuration and split by
the reference's parameter list (`reference.train.param_shapes`), in float32,
the type the program keeps its parameters in: linear weights, embeddings
and biases N(0, 0.02), convolutions N(0, 1/fan_in), norm scales
1 + N(0, 0.02).

A batch is the global batch of one step (every chip's rows, in rank
order): NHWC float32 images N(0, 1) (a normalised batch), uniform labels
and, for token-label recipes, the top-K token scores and class indices of
every token (scores of a token sum to a share U(0.6, 1) of a unit, as the
top of a softmax does) and one MixToken box, drawn as MixToken draws it:
lambda ~ U(0, 1), side = floor(grid * sqrt(1 - lambda)), centred on a
uniform token and clipped to the grid. Every batch has the same sizes,
whatever the seed.
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import Dict, Tuple

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def make_weights(shapes: Dict[str, Tuple[Tuple[int, ...], str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device` (views into one buffer)."""
    sizes = [math.prod(shape) for shape, _ in shapes.values()]
    g = torch.Generator(device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (name, (shape, kind)), part in zip(shapes.items(), flat.split(sizes)):
        if kind == "conv":
            part.mul_(math.sqrt(1.0 / math.prod(shape[1:])))
        elif kind == "norm":
            part.mul_(0.02).add_(1.0)
        elif kind in ("linear", "embed", "bias"):
            part.mul_(0.02)
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        out[name] = part.view(shape)
    return out


def mix_box(rng: random.Random, grid: int) -> Tuple[int, int, int, int]:
    lam = rng.random()
    cut = int(grid * math.sqrt(1.0 - lam))
    cx, cy = rng.randrange(grid), rng.randrange(grid)
    clip = lambda v: min(max(v, 0), grid)  # noqa: E731
    return (clip(cx - cut // 2), clip(cy - cut // 2), clip(cx + cut // 2), clip(cy + cut // 2))


def make_batch(cell: dict, cfg: dict, seed: int, k: int, global_batch: int,
               device) -> dict:
    """Global batch `k` of the pool."""
    r, C = cell["img_size"], cfg["num_classes"]
    g = torch.Generator(device).manual_seed(derive(seed, "batch", k))
    out = {"image": torch.randn(global_batch, r, r, 3, generator=g, device=device),
           "label": torch.randint(0, C, (global_batch,), generator=g, device=device)}
    recipe = cell["recipe"]
    if recipe["loss"] == "token_label":
        K, t = recipe["token_label_topk"], cfg["token_label_grid"]
        s = torch.rand(global_batch, K, t, t, generator=g, device=device)
        share = 0.6 + 0.4 * torch.rand(global_batch, 1, t, t, generator=g, device=device)
        out["label_scores"] = s / s.sum(1, keepdim=True) * share
        out["label_inds"] = torch.randint(0, C, (global_batch, K, t, t), generator=g,
                                          device=device, dtype=torch.int32)
    if recipe.get("mix_token"):
        grid = r // cfg["patch_size"] // cfg["pooling_scale"]
        out["bbox"] = mix_box(random.Random(derive(seed, "box", k)), grid)
    return out


def rows(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s share of a global batch (the box is shared)."""
    out = {}
    for key, v in batch.items():
        if isinstance(v, torch.Tensor):
            n = v.shape[0] // world
            out[key] = v[rank * n:(rank + 1) * n].clone()
        else:
            out[key] = v
    return out
