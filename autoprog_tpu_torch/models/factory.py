"""Model descriptions and registry entries, counterpart of
`autoprog_tpu/models/factory.py`.

`volo_d1..d5`, the `volo_h{H}_l{L}` supernet grammar and the fixed-width
`volod4_h{H}_l{L}` / `volod5_h{H}_l{L}` families build VOLO; the eight DeiT
names and the `deit_h{H}_l{L}` grammar build `models/vit.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from autoprog_tpu_torch.config import parse_variant_name
from autoprog_tpu_torch.prog.depth import volo_depth_split
from autoprog_tpu_torch.models.vit import VisionTransformer
from autoprog_tpu_torch.models.volo import VOLO
from autoprog_tpu_torch.registry import register_model

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _volo_cfg(crop_pct: float = 0.96) -> Dict[str, Any]:
    return dict(num_classes=1000, input_size=(3, 224, 224), crop_pct=crop_pct,
                interpolation="bicubic", mean=IMAGENET_MEAN, std=IMAGENET_STD)


def _deit_cfg() -> Dict[str, Any]:
    return dict(num_classes=1000, input_size=(3, 224, 224), crop_pct=0.9,
                interpolation="bicubic", mean=IMAGENET_MEAN, std=IMAGENET_STD)


@dataclasses.dataclass(frozen=True)
class VoloArch:
    """Static architecture record for a VOLO model."""
    layers: Tuple[int, ...]
    embed_dims: Tuple[int, ...]
    num_heads: Tuple[int, ...]
    mlp_ratios: Tuple[int, ...] = (3, 3, 3, 3)
    downsamples: Tuple[bool, ...] = (True, False, False, False)
    outlook_attention: Tuple[bool, ...] = (True, False, False, False)
    post_layers: Tuple[str, ...] = ("ca", "ca")
    stem_hidden_dim: int = 64
    patch_size: int = 8
    family: str = "volo"

    @property
    def total_layers(self) -> int:
        return sum(self.layers)


@dataclasses.dataclass(frozen=True)
class DeitArch:
    """Static architecture record for a DeiT/ViT model (single stage)."""
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 16
    mlp_ratio: float = 4.0
    distilled: bool = False
    family: str = "deit"

    @property
    def layers(self) -> Tuple[int, ...]:
        return (self.depth,)

    @property
    def embed_dims(self) -> Tuple[int, ...]:
        return (self.embed_dim,)

    @property
    def total_layers(self) -> int:
        return self.depth


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    arch: Union[VoloArch, DeitArch]
    default_cfg: Dict[str, Any]

    def make(self, *, num_classes: int = 1000, img_size: int = 224,
             drop_rate: float = 0.0, drop_path_rate: float = 0.0,
             attn_drop_rate: float = 0.0, dtype=torch.bfloat16,
             mix_token=None, return_dense=None, bn_momentum=None, bn_eps=None,
             aux_fusion: str = "max") -> Union[VOLO, VisionTransformer]:
        a = self.arch
        if isinstance(a, DeitArch):
            return VisionTransformer(
                embed_dim=a.embed_dim, depth=a.depth, num_heads=a.num_heads,
                patch_size=a.patch_size, mlp_ratio=a.mlp_ratio, num_classes=num_classes,
                distilled=a.distilled, img_size=img_size, drop_rate=drop_rate,
                attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate, dtype=dtype)
        bn_kw = {}
        if bn_momentum is not None:
            bn_kw["bn_momentum"] = bn_momentum
        if bn_eps is not None:
            bn_kw["bn_eps"] = bn_eps
        return VOLO(layers=a.layers, embed_dims=a.embed_dims, num_heads=a.num_heads,
                    mlp_ratios=a.mlp_ratios, downsamples=a.downsamples,
                    outlook_attention=a.outlook_attention, post_layers=a.post_layers,
                    img_size=img_size, patch_size=a.patch_size,
                    stem_hidden_dim=a.stem_hidden_dim, num_classes=num_classes,
                    drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                    drop_path_rate=drop_path_rate,
                    mix_token=True if mix_token is None else mix_token,
                    return_dense=True if return_dense is None else return_dense,
                    dtype=dtype, aux_fusion=aux_fusion, **bn_kw)


def volo_variant_arch(h: int, l: int) -> VoloArch:
    """`volo_h{H}_l{L}`: embed_dims [16h, 32h, 32h, 32h], heads
    [h/2, h, h, h], depth split [l0, l - l0, 0, 0]."""
    if h % 2 != 0:
        raise ValueError("h must be divisible by 2")
    l0, l1 = volo_depth_split(l)
    return VoloArch(layers=(l0, l1, 0, 0), embed_dims=(h * 16, h * 32, h * 32, h * 32),
                    num_heads=(h // 2, h, h, h))


def deit_variant_arch(h: int, l: int) -> DeitArch:
    """`deit_h{H}_l{L}`: embed_dim = 64h (head_dim 64), depth l."""
    return DeitArch(embed_dim=64 * h, depth=l, num_heads=h)


def volo_fixed_width_arch(h: int, l: int, *, dims, heads, mlp, stem,
                          family: str) -> VoloArch:
    """Elastic-depth family with pinned width (volod4 / volod5)."""
    if h != heads[1]:
        raise ValueError(
            f"{family} has fixed width (transformer heads {heads[1]}); "
            f"got h{h} — width growth is not supported for this family")
    l0, l1 = volo_depth_split(l)
    return VoloArch(layers=(l0, l1, 0, 0), embed_dims=dims, num_heads=heads,
                    mlp_ratios=mlp, stem_hidden_dim=stem)


_FIXED_WIDTH_FAMILIES = {
    "volod4": ((384, 768, 768, 768), (12, 16, 16, 16), (3, 3, 3, 3), 64, 1.15),
    "volod5": ((384, 768, 768, 768), (12, 16, 16, 16), (4, 4, 4, 4), 128, 1.15),
}


@register_model
def model_variant(variant: str = "", **kwargs) -> ModelDef:
    family, h, l = parse_variant_name(variant)
    if family == "volo":
        return ModelDef(variant, volo_variant_arch(h, l), _volo_cfg())
    if family == "deit":
        return ModelDef(variant, deit_variant_arch(h, l), _deit_cfg())
    if family in _FIXED_WIDTH_FAMILIES:
        dims, heads, mlp, stem, crop = _FIXED_WIDTH_FAMILIES[family]
        return ModelDef(variant, volo_fixed_width_arch(h, l, dims=dims, heads=heads,
                                                       mlp=mlp, stem=stem,
                                                       family=family),
                        _volo_cfg(crop))
    raise ValueError(f"unknown variant family {family!r}")


def _volo(name, layers, dims, heads, mlp, crop_pct=0.96, stem=64):
    return ModelDef(name, VoloArch(layers=layers, embed_dims=dims, num_heads=heads,
                                   mlp_ratios=mlp, stem_hidden_dim=stem),
                    _volo_cfg(crop_pct))


@register_model
def volo_d1(**kw):
    return _volo("volo_d1", (4, 4, 8, 2), (192, 384, 384, 384), (6, 12, 12, 12), (3, 3, 3, 3))


@register_model
def volo_d2(**kw):
    return _volo("volo_d2", (6, 4, 10, 4), (256, 512, 512, 512), (8, 16, 16, 16), (3, 3, 3, 3))


@register_model
def volo_d3(**kw):
    return _volo("volo_d3", (8, 8, 16, 4), (256, 512, 512, 512), (8, 16, 16, 16), (3, 3, 3, 3))


@register_model
def volo_d4(**kw):
    return _volo("volo_d4", (8, 8, 16, 4), (384, 768, 768, 768), (12, 16, 16, 16),
                 (3, 3, 3, 3), crop_pct=1.15)


@register_model
def volo_d5(**kw):
    return _volo("volo_d5", (12, 12, 20, 4), (384, 768, 768, 768), (12, 16, 16, 16),
                 (4, 4, 4, 4), crop_pct=1.15, stem=128)


def _register_deit(name: str, dim: int, depth: int, heads: int, distilled: bool = False,
                   **cfg) -> None:
    def builder(**kw):
        return ModelDef(name, DeitArch(embed_dim=dim, depth=depth, num_heads=heads,
                                       distilled=distilled), {**_deit_cfg(), **cfg})
    builder.__name__ = name
    register_model(builder)


_AT_384 = dict(input_size=(3, 384, 384), crop_pct=1.0)
_register_deit("deit_tiny_patch16_224", 192, 12, 3)
_register_deit("deit_small_patch16_224", 384, 12, 6)
_register_deit("deit_base_patch16_224", 768, 12, 12)
_register_deit("deit_tiny_distilled_patch16_224", 192, 12, 3, True)
_register_deit("deit_small_distilled_patch16_224", 384, 12, 6, True)
_register_deit("deit_base_distilled_patch16_224", 768, 12, 12, True)
_register_deit("deit_base_patch16_384", 768, 12, 12, **_AT_384)
_register_deit("deit_base_distilled_patch16_384", 768, 12, 12, True, **_AT_384)
