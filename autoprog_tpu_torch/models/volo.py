"""VOLO (Vision Outlooker), counterpart of `autoprog_tpu/models/volo.py`.

conv stem -> outlooker stage -> 2x downsample -> pos-embed -> transformer
stages -> class-attention post-network -> cls and dense aux heads, with
MixToken on the embeddings in training and `cls + 0.5 * max(aux)` at eval.

  * Resolution elasticity: the pos-embed is resized bicubically (Keys
    a = -0.5) to the token grid of the input.
  * Depth elasticity: `keep` is a static per-layer mask (tuple of tuples of
    bools, `autoprog_tpu/prog/depth.py:elastic_keep_masks`); a skipped layer
    is not run. Parameters of every layer always exist.
  * `forward(..., bbox=...)` takes an injected MixToken box; without one the
    box is drawn from `mix_gen` (a CPU `torch.Generator`), outside the
    blocks that `remat` ("" | "full" | "dots", `layers.remat_call`)
    recomputes in the backward.
  * `model_parallel` M > 1 builds every block and post block on this rank's
    shard (`parallel/tp.py`); the stem, `patch_embed`, `pos_embed`,
    `cls_token`, `norm`, the heads and the downsamples stay whole.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from autoprog_tpu_torch.models.layers import (
    ClassBlock,
    Dense,
    Downsample,
    LayerNorm,
    Outlooker,
    PatchEmbed,
    TransformerBlock,
    dropout,
    remat_call,
    trunc_init_,
)
from autoprog_tpu_torch.ops.interpolate import resize_bicubic
from autoprog_tpu_torch.ops.mixtoken import mix_tokens, rand_bbox, unmix_tokens
from autoprog_tpu_torch.utils import spans

KeepMasks = Tuple[Tuple[bool, ...], ...]


class VOLO(nn.Module):
    def __init__(self, *, layers, embed_dims, num_heads, mlp_ratios=(3, 3, 3, 3),
                 downsamples=(True, False, False, False),
                 outlook_attention=(True, False, False, False),
                 post_layers=("ca", "ca"), img_size: int = 224, patch_size: int = 8,
                 stem_hidden_dim: int = 64, num_classes: int = 1000,
                 qkv_bias: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 return_mean: bool = False, return_dense: bool = True,
                 mix_token: bool = True, pooling_scale: int = 2, out_kernel: int = 3,
                 out_stride: int = 2, out_padding: int = 1, aux_fusion: str = "max",
                 dtype: torch.dtype = torch.bfloat16, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5, remat="", model_parallel: int = 1):
        super().__init__()
        self.remat = remat
        self.layers = tuple(layers)
        self.outlook = tuple(outlook_attention)
        self.downsamples = tuple(downsamples)
        self.post_layers = tuple(post_layers or ())
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        self.return_mean, self.return_dense = return_mean, return_dense
        self.mix_token, self.pooling_scale = mix_token, pooling_scale
        self.aux_fusion, self.dtype = aux_fusion, dtype

        self.patch_embed = PatchEmbed(embed_dims[0], patch_size, 2, stem_hidden_dim,
                                      dtype=dtype, bn_momentum=bn_momentum,
                                      bn_eps=bn_eps)
        total = sum(self.layers)
        dpr = lambda i: 0.0 if total <= 1 else drop_path_rate * i / (total - 1)
        gidx = 0
        pos_added = False
        for s, nl in enumerate(self.layers):
            if not self.outlook[s] and not pos_added:
                g = img_size // patch_size // pooling_scale
                self.pos_embed = nn.Parameter(trunc_init_(torch.empty(1, g, g, embed_dims[-1])))
                pos_added = True
            for i in range(nl):
                if self.outlook[s]:
                    blk = Outlooker(embed_dims[s], num_heads[s], out_kernel, out_padding,
                                    out_stride, mlp_ratios[s], qkv_bias, attn_drop_rate,
                                    dpr(gidx), dtype, model_parallel)
                else:
                    blk = TransformerBlock(embed_dims[s], num_heads[s], mlp_ratios[s],
                                           qkv_bias, attn_drop_rate, dpr(gidx), dtype,
                                           model_parallel)
                self.add_module(f"s{s}b{i}", blk)
                gidx += 1
            if self.downsamples[s]:
                self.add_module(f"ds{s}", Downsample(embed_dims[s], embed_dims[s + 1], 2, dtype))
        C = embed_dims[-1]
        if self.post_layers:
            self.cls_token = nn.Parameter(trunc_init_(torch.empty(1, 1, C)))
            for pi, kind in enumerate(self.post_layers):
                if kind != "ca":
                    raise ValueError(f"unknown post layer {kind}")
                self.add_module(f"post{pi}", ClassBlock(C, num_heads[-1],
                                                        mlp_ratio=mlp_ratios[-1],
                                                        qkv_bias=qkv_bias,
                                                        attn_drop=attn_drop_rate,
                                                        dtype=dtype,
                                                        model_parallel=model_parallel))
        self.norm = LayerNorm(C, dtype)
        self.head = Dense(C, num_classes, dtype=dtype)
        if return_dense and not return_mean:
            self.aux_head = Dense(C, num_classes, dtype=dtype)

    def _keep(self, keep) -> KeepMasks:
        if keep is None:
            return tuple((True,) * n for n in self.layers)
        keep = tuple(tuple(k) for k in keep) + tuple(
            (True,) * n for n in self.layers[len(keep):])
        if any(len(keep[i]) != n for i, n in enumerate(self.layers)):
            raise ValueError(f"keep mask lengths {[len(k) for k in keep]} != "
                             f"layers {self.layers}")
        return keep

    def forward(self, x: torch.Tensor, *, train: bool = False,
                keep: Optional[KeepMasks] = None, bbox: Optional[torch.Tensor] = None,
                drop_gen: Optional[torch.Generator] = None,
                mix_gen: Optional[torch.Generator] = None):
        """x: NHWC images. Train mode returns (x_cls, x_aux, bbox) with the
        aux tokens un-mixed; eval returns the fused logits [B, classes]."""
        keep = self._keep(keep)
        with spans.span("model.stem"):
            x = self.patch_embed(x, train=train)          # [B, r/8, r/8, C0]
            use_mix = self.mix_token and train
            if use_mix:
                ps = self.pooling_scale
                if bbox is None:
                    bbox = rand_bbox(mix_gen, x.shape[1] // ps, x.shape[2] // ps)
                x = mix_tokens(x, bbox, scale=ps)
            else:
                bbox = torch.zeros(4, dtype=torch.int32)
        spans.mark_backward(x, "model.stem")

        # the outlook stages come first: the transformer stages start at the
        # pos-embed, added before the first stage without outlook attention
        first_t = self.outlook.index(False) if False in self.outlook else len(self.layers)
        with spans.span("model.outlookers"):
            x = self._stages(x, range(first_t), keep, train, drop_gen)
        spans.mark_backward(x, "model.outlookers")
        with spans.span("model.transformers"):
            if first_t < len(self.layers):
                pe = resize_bicubic(self.pos_embed, (x.shape[1], x.shape[2]))
                x = dropout(x + pe.to(self.dtype), self.drop_rate, train, drop_gen)
                x = self._stages(x, range(first_t, len(self.layers)), keep, train, drop_gen)
        spans.mark_backward(x, "model.transformers")
        with spans.span("model.head"):
            return self._head(x, train, use_mix, bbox, drop_gen)

    def _stages(self, x, stages, keep: KeepMasks, train: bool, drop_gen):
        """The kept blocks of `stages`, each stage followed by its downsample."""
        for s in stages:
            for i in range(self.layers[s]):
                if not keep[s][i]:
                    continue
                blk = getattr(self, f"s{s}b{i}")
                if self.outlook[s]:
                    x = remat_call(blk, x, train, drop_gen, self.remat)
                else:
                    B, H, W, C = x.shape
                    x = remat_call(blk, x.reshape(B, H * W, C), train, drop_gen,
                                   self.remat).reshape(B, H, W, C)
            if self.downsamples[s]:
                x = getattr(self, f"ds{s}")(x)
        return x

    def _head(self, x, train: bool, use_mix: bool, bbox, drop_gen):
        """Class attention, norm and heads; un-mixes the aux tokens."""
        B, H, W, C = x.shape
        x = x.reshape(B, H * W, C)
        if self.post_layers:
            cls = self.cls_token.to(self.dtype).expand(B, 1, C)
            x = torch.cat([cls, x], dim=1)
            for pi in range(len(self.post_layers)):
                x = getattr(self, f"post{pi}")(x, train, drop_gen)
        x = self.norm(x)

        if self.return_mean:
            return self.head(x.mean(dim=1))
        x_cls = self.head(x[:, 0])
        if not self.return_dense:
            return x_cls
        x_aux = self.aux_head(x[:, 1:])                    # [B, N, classes]
        if not train:
            pooled = x_aux.amax(dim=1) if self.aux_fusion == "max" else x_aux.mean(dim=1)
            return x_cls + 0.5 * pooled
        if use_mix:
            x_aux = unmix_tokens(x_aux.reshape(B, H, W, self.num_classes), bbox)
            x_aux = x_aux.reshape(B, H * W, self.num_classes)
        return x_cls, x_aux, bbox
