"""DeiT / plain ViT, counterpart of `autoprog_tpu/models/vit.py`.

patchify conv -> cls (and dist) token -> pos-embed -> transformer blocks ->
norm -> head (and head_dist). As in the JAX module, two things go beyond the
stock model for the progressive engine:

  * Depth elasticity: `keep` is a static per-layer mask like VOLO's (one
    stage); a skipped layer is not run.
  * Resolution elasticity: the grid part of the pos-embed is resized
    bicubically (Keys a = -0.5, `ops/interpolate.py`) to the token grid of
    the input; the prefix tokens' embeddings are kept.

Blocks are named `s0b{i}` so that `prog/growth.py` treats VOLO and DeiT
alike. The distilled model returns (x_cls, x_dist) in training and the mean
of the two heads at eval. `forward` takes and ignores VOLO's `bbox` and
`mix_gen` (DeiT has no MixToken), so the train step calls both alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from autoprog_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    TransformerBlock,
    dropout,
    trunc_init_,
)
from autoprog_tpu_torch.ops.interpolate import resize_bicubic


class VisionTransformer(nn.Module):
    def __init__(self, *, embed_dim: int, depth: int, num_heads: int,
                 patch_size: int = 16, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 num_classes: int = 1000, distilled: bool = False, img_size: int = 224,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embed_dim, self.depth, self.patch_size = embed_dim, depth, patch_size
        self.distilled, self.img_size = distilled, img_size
        self.drop_rate, self.dtype = drop_rate, dtype
        self.patch_embed = Conv(3, embed_dim, patch_size, patch_size, 0, True, dtype)
        g0 = img_size // patch_size
        self.pos_embed = nn.Parameter(trunc_init_(
            torch.empty(1, g0 * g0 + self.n_prefix, embed_dim)))
        self.cls_token = nn.Parameter(trunc_init_(torch.empty(1, 1, embed_dim)))
        if distilled:
            self.dist_token = nn.Parameter(trunc_init_(torch.empty(1, 1, embed_dim)))
        for i in range(depth):
            dp = drop_path_rate * i / max(depth - 1, 1)
            self.add_module(f"s0b{i}", TransformerBlock(
                embed_dim, num_heads, mlp_ratio, qkv_bias, attn_drop_rate, dp, dtype))
        self.norm = LayerNorm(embed_dim, dtype)
        self.head = Dense(embed_dim, num_classes, dtype=dtype)
        if distilled:
            self.head_dist = Dense(embed_dim, num_classes, dtype=dtype)

    @property
    def n_prefix(self) -> int:
        return 2 if self.distilled else 1

    def forward(self, x: torch.Tensor, *, train: bool = False,
                keep: Optional[Tuple[Tuple[bool, ...], ...]] = None, bbox=None,
                drop_gen: Optional[torch.Generator] = None, mix_gen=None):
        """x: NHWC images. Returns the logits [B, classes]; the distilled
        model in training returns (x_cls, x_dist)."""
        keep_flat = (True,) * self.depth if keep is None else tuple(keep[0])
        if len(keep_flat) != self.depth:
            raise ValueError(f"keep mask length {len(keep_flat)} != depth {self.depth}")
        B, C = x.shape[0], self.embed_dim
        x = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # [B, g, g, C]
        gh, gw = x.shape[1], x.shape[2]
        tokens = [self.cls_token.to(self.dtype).expand(B, 1, C)]
        if self.distilled:
            tokens.append(self.dist_token.to(self.dtype).expand(B, 1, C))
        x = torch.cat(tokens + [x.reshape(B, gh * gw, C)], dim=1)

        g0 = self.img_size // self.patch_size
        np_ = self.n_prefix
        pe_grid = self.pos_embed[:, np_:].reshape(1, g0, g0, C)
        pe_grid = resize_bicubic(pe_grid, (gh, gw)).reshape(1, gh * gw, C)
        pe = torch.cat([self.pos_embed[:, :np_], pe_grid], dim=1)
        x = dropout(x + pe.to(self.dtype), self.drop_rate, train, drop_gen)

        for i in range(self.depth):
            if keep_flat[i]:
                x = getattr(self, f"s0b{i}")(x, train, drop_gen)

        x = self.norm(x)
        x_cls = self.head(x[:, 0])
        if not self.distilled:
            return x_cls
        x_dist = self.head_dist(x[:, 1])
        if train:
            return x_cls, x_dist
        return (x_cls + x_dist) / 2
