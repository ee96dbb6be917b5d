"""Plain DeiT (Touvron et al., "Training data-efficient image transformers
& distillation through attention", arXiv 2012.12877), the ViT without the
distillation token, in float32 PyTorch on a dictionary of parameters:
patchify convolution -> class token -> position embedding -> pre-norm
transformer blocks -> LayerNorm -> linear head on the class token.

Departures from the paper's code, each one what the configuration file
states (its `semantics`): GELU is the tanh approximation and LayerNorm's
eps is 1e-6. Blocks are named `s0b0..`; linear weights are [out, in], the
patch convolution OIHW, the position embedding [1, 1 + N, C].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics
from benchmark.reference.volo import _checkpointed, _lin, _ln, _mhsa, _mlp

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind), as `volo.param_shapes`."""
    C, p = cfg["embed_dim"], cfg["patch_size"]
    hidden = int(C * cfg["mlp_ratio"])
    n = (cfg["img_size"] // p) ** 2
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "patch_embed.weight": ((C, 3, p, p), "conv"),
        "patch_embed.bias": ((C,), "bias"),
        "pos_embed": ((1, n + 1, C), "embed"),
        "cls_token": ((1, 1, C), "embed"),
    }
    for i in range(cfg["depth"]):
        b = f"s0b{i}"
        out[b + ".norm1.weight"], out[b + ".norm1.bias"] = ((C,), "norm"), ((C,), "bias")
        out[b + ".attn.qkv.weight"] = ((3 * C, C), "linear")
        if cfg["qkv_bias"]:
            out[b + ".attn.qkv.bias"] = ((3 * C,), "bias")
        out[b + ".attn.proj.weight"], out[b + ".attn.proj.bias"] = ((C, C), "linear"), \
            ((C,), "bias")
        out[b + ".norm2.weight"], out[b + ".norm2.bias"] = ((C,), "norm"), ((C,), "bias")
        out[b + ".mlp.fc1.weight"], out[b + ".mlp.fc1.bias"] = ((hidden, C), "linear"), \
            ((hidden,), "bias")
        out[b + ".mlp.fc2.weight"], out[b + ".mlp.fc2.bias"] = ((C, hidden), "linear"), \
            ((C,), "bias")
    out["norm.weight"], out["norm.bias"] = ((C,), "norm"), ((C,), "bias")
    out["head.weight"] = ((cfg["num_classes"], C), "linear")
    out["head.bias"] = ((cfg["num_classes"],), "bias")
    return out


def forward(P: Params, images: torch.Tensor, bbox, cfg: dict, num: Numerics,
            checkpoint_blocks: bool = False):
    """Training forward on NHWC images: (class logits [B, classes],). DeiT
    has no MixToken; `bbox` is ignored."""
    eps = cfg["semantics"]["layer_norm_eps"]
    w = P["patch_embed.weight"]
    x = F.conv2d(num.q(images.permute(0, 3, 1, 2)), num.q(w), P["patch_embed.bias"],
                 w.shape[-1])
    B, C = x.shape[0], x.shape[1]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([P["cls_token"].expand(B, 1, C), x], dim=1) + P["pos_embed"]
    for i in range(cfg["depth"]):
        p = f"s0b{i}"

        def block(y, p=p):
            y = y + _mhsa(num, _ln(y, P, p + ".norm1", eps), P, p + ".attn", cfg["num_heads"])
            return y + _mlp(num, _ln(y, P, p + ".norm2", eps), P, p + ".mlp")
        x = _checkpointed(block, x, checkpoint_blocks)
    x = _ln(x, P, "norm", eps)
    return (_lin(num, x[:, 0], P, "head"),)
