"""Transfer learning, counterpart of `autoprog_tpu/finetune.py`.

Loads a checkpoint's weights (either package's file) into a model of
another resolution or class count:
  * the pos-embed grid is resized bicubically (Keys a = -0.5, as the JAX
    package), VOLO's [1, H, W, C] grid (`resize_pos_embed_4d`) and DeiT's
    [1, prefix + g*g, C] tokens with their cls / dist prefix kept
    (`resize_pos_embed_tokens`);
  * the classifier heads (`head`, `aux_head`, `head_dist`) keep their
    initialisation where the class count changed (their shape differs);
  * every other parameter is matched by name; a name the checkpoint lacks,
    or whose shape differs, keeps its initialisation (logged).
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import torch

from autoprog_tpu_torch.ops.interpolate import resize_bicubic
from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file

_logger = logging.getLogger("autoprog_tpu_torch")

HEADS = ("head", "aux_head", "head_dist")


def resize_pos_embed_4d(src: torch.Tensor, dst_shape) -> torch.Tensor:
    """[1, h, w, C] -> [1, H, W, C]."""
    return resize_bicubic(src, tuple(dst_shape[1:3]))


def resize_pos_embed_tokens(src: torch.Tensor, dst_shape, n_prefix: int) -> torch.Tensor:
    """[1, p + g*g, C] -> [1, p + G*G, C], the p prefix tokens kept."""
    C = src.shape[-1]
    g = math.isqrt(src.shape[1] - n_prefix)
    G = math.isqrt(dst_shape[1] - n_prefix)
    grid = resize_bicubic(src[:, n_prefix:].reshape(1, g, g, C), (G, G))
    return torch.cat([src[:, :n_prefix], grid.reshape(1, G * G, C)], dim=1)


def adapt_state_dict(src: Dict[str, torch.Tensor], dst: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """`dst`'s names and shapes, filled from `src` where it fits."""
    out = {}
    for name, tmpl in dst.items():
        if name not in src:
            _logger.info("finetune: no pretrained value for %s", name)
            out[name] = tmpl
            continue
        value = src[name]
        parts = name.split(".")
        if (parts[-1] in HEADS or (len(parts) >= 2 and parts[-2] in HEADS)) and \
                value.shape != tmpl.shape:
            _logger.info("finetune: dropping %s (classes changed)", name)
            out[name] = tmpl
        elif parts[-1] == "pos_embed" and value.shape != tmpl.shape:
            if value.ndim == 4:
                out[name] = resize_pos_embed_4d(value, tmpl.shape).to(tmpl.dtype)
            else:
                n_prefix = 1 if tmpl.shape[1] % 2 == 1 else 2
                out[name] = resize_pos_embed_tokens(value, tmpl.shape, n_prefix).to(tmpl.dtype)
        elif value.shape != tmpl.shape:
            _logger.warning("finetune: shape mismatch at %s: %s vs %s; keeping init", name,
                            tuple(value.shape), tuple(tmpl.shape))
            out[name] = tmpl
        else:
            out[name] = value.to(tmpl.dtype)
    return out


def load_pretrained_weights(model: torch.nn.Module, checkpoint_path: str, *,
                            use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """Load a checkpoint's parameters (its first EMA tree with `use_ema`,
    where the file has one) into `model`'s parameters, in place, adapted by
    `adapt_state_dict`; returns the loaded state_dict."""
    ckpt = load_checkpoint_file(checkpoint_path)
    key = "state_dict"
    if use_ema and "state_dict_ema_0" in ckpt:
        key = "state_dict_ema_0"
    params = dict(model.named_parameters())
    loaded = adapt_state_dict(ckpt[key], {n: p.detach() for n, p in params.items()})
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(loaded[n])
    return loaded
