"""Plain VOLO (Yuan et al., "VOLO: Vision Outlooker for Visual
Recognition", arXiv 2106.13112) in float32 PyTorch: the training forward
with MixToken, written from the paper and its published code, on a
dictionary of parameters.

conv stem (3 x conv-BN-ReLU, stride 2, then a patch projection) ->
MixToken on the token map -> outlookers -> 2x2 downsample -> position
embedding -> transformers -> two class-attention blocks -> LayerNorm ->
class head on the class token and the dense aux head on the other tokens,
the aux map un-mixed.

Departures from the paper's code, each one what the configuration file
states (its `semantics`), so that the reference computes the function the
program is asked to compute:

  * GELU is the tanh approximation; LayerNorm's eps is 1e-6;
  * BatchNorm in training normalises by the biased batch variance (the
    running statistics are not kept: nothing compared reads them);
  * the transformers of the paper's stages 2-4 (equal width, no
    downsample between them) are one run of blocks, named `s1b0..`; the
    outlookers are `s0b0..`, the downsample `ds0`, the class-attention
    blocks `post0..`; every parameter's name and layout is the interface
    through which the benchmark hands both sides the same weights
    (linear weights [out, in], convolutions OIHW, the position embedding
    [1, h, w, C] added as it is at the native resolution);
  * MixToken's box comes from the caller (the benchmark draws it from the
    seed), in units of the 2x-pooled token grid: (x1, y1, x2, y2) with the
    first pair bounding rows; the box region of each image is swapped with
    that of the image at the mirrored batch position, B-1-i, and the aux
    map is swapped back.

Outlook attention uses `F.unfold` / `F.fold`, as the paper's code does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics

Params = Dict[str, torch.Tensor]


def param_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind); kind is how the benchmark draws it: `linear`,
    `conv` (fan-in scaled), `bias`, `norm` (around 1) or `embed`."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    dims, heads, mlp = cfg["embed_dims"], cfg["num_heads"], cfg["mlp_ratios"]
    hid, k = cfg["stem_hidden_dim"], cfg["outlook_kernel"]
    qkv_bias = cfg["qkv_bias"]

    def lin(name, i, o, bias=True):
        out[name + ".weight"] = ((o, i), "linear")
        if bias:
            out[name + ".bias"] = ((o,), "bias")

    def norm(name, c):
        out[name + ".weight"] = ((c,), "norm")
        out[name + ".bias"] = ((c,), "bias")

    def mlp_(name, c, r):
        lin(name + ".fc1", c, int(c * r))
        lin(name + ".fc2", int(c * r), c)

    ch = 3
    for i, ks in enumerate((7, 3, 3)):
        out[f"patch_embed.stem{i}.conv.weight"] = ((hid, ch, ks, ks), "conv")
        norm(f"patch_embed.stem{i}.bn", hid)
        ch = hid
    ps = cfg["patch_size"] // 2
    out["patch_embed.proj.weight"] = ((dims[0], hid, ps, ps), "conv")
    out["patch_embed.proj.bias"] = ((dims[0],), "bias")
    n_out, n_tr = _split(cfg)
    c0, c1 = dims[0], dims[-1]
    for i in range(n_out):
        p = f"s0b{i}"
        norm(p + ".norm1", c0)
        lin(p + ".attn.v", c0, c0, qkv_bias)
        lin(p + ".attn.attn", c0, k ** 4 * heads[0])
        lin(p + ".attn.proj", c0, c0)
        norm(p + ".norm2", c0)
        mlp_(p + ".mlp", c0, mlp[0])
    out["ds0.proj.weight"] = ((c1, c0, 2, 2), "conv")
    out["ds0.proj.bias"] = ((c1,), "bias")
    g = cfg["img_size"] // cfg["patch_size"] // 2
    out["pos_embed"] = ((1, g, g, c1), "embed")
    for i in range(n_tr):
        p = f"s1b{i}"
        norm(p + ".norm1", c1)
        lin(p + ".attn.qkv", c1, 3 * c1, qkv_bias)
        lin(p + ".attn.proj", c1, c1)
        norm(p + ".norm2", c1)
        mlp_(p + ".mlp", c1, mlp[-1])
    out["cls_token"] = ((1, 1, c1), "embed")
    for i in range(cfg["post_layers"]):
        p = f"post{i}"
        norm(p + ".norm1", c1)
        lin(p + ".attn.kv", c1, 2 * c1, qkv_bias)
        lin(p + ".attn.q", c1, c1, qkv_bias)
        lin(p + ".attn.proj", c1, c1)
        norm(p + ".norm2", c1)
        mlp_(p + ".mlp", c1, mlp[-1])
    norm("norm", c1)
    lin("head", c1, cfg["num_classes"])
    lin("aux_head", c1, cfg["num_classes"])
    return out


def _split(cfg: dict) -> Tuple[int, int]:
    """(outlookers, transformers): the paper's first stage is outlookers,
    the rest transformers."""
    layers, outlook = cfg["layers"], cfg["outlook_attention"]
    if not outlook[0] or any(outlook[1:]) or not cfg["downsamples"][0] \
            or any(cfg["downsamples"][1:]) or len(set(cfg["embed_dims"][1:])) != 1:
        raise ValueError("the reference VOLO takes one outlook stage, one downsample "
                         "after it, and transformer stages of one width")
    return layers[0], sum(layers[1:])


def _lin(num: Numerics, x, P: Params, name: str):
    b = P.get(name + ".bias")
    return F.linear(num.q(x), num.q(P[name + ".weight"]), b)


def _ln(x, P: Params, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], eps)


def _mlp(num, x, P, name):
    return _lin(num, F.gelu(_lin(num, x, P, name + ".fc1"), approximate="tanh"), P,
                name + ".fc2")


def _conv_bn_relu(num, x, P, name, stride, eps):
    w = P[name + ".conv.weight"]
    x = F.conv2d(num.q(x), num.q(w), None, stride, w.shape[-1] // 2)
    mean = x.mean((0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * P[name + ".bn.weight"][:, None, None] + P[name + ".bn.bias"][:, None, None]
    return F.relu(y)


def box_mask(bbox, grid: int, scale: int, device) -> torch.Tensor:
    """[grid*scale, grid*scale] bool, True inside the box (rows by the
    first pair)."""
    x1, y1, x2, y2 = (int(v) * scale for v in bbox)
    r = torch.arange(grid * scale, device=device)
    return ((r[:, None] >= x1) & (r[:, None] < x2)) & ((r[None, :] >= y1) & (r[None, :] < y2))


def _outlook(num, x, P, name, heads, k, pad, stride):
    B, H, W, C = x.shape
    d, kk = C // heads, k * k
    h, w = math.ceil(H / stride), math.ceil(W / stride)
    v = _lin(num, x, P, name + ".v").permute(0, 3, 1, 2)
    cols = F.unfold(v, k, padding=pad, stride=stride)                  # [B, C kk, h w]
    cols = cols.reshape(B, heads, d, kk, h * w).permute(0, 1, 4, 3, 2)  # [B, hd, L, kk, d]
    pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), stride, stride, ceil_mode=True)
    a = _lin(num, pooled.permute(0, 2, 3, 1), P, name + ".attn")
    a = a.reshape(B, h * w, heads, kk, kk).permute(0, 2, 1, 3, 4)
    a = torch.softmax(a * d ** -0.5, dim=-1)
    o = torch.matmul(num.q(a), num.q(cols))                            # [B, hd, L, kk, d]
    o = o.permute(0, 1, 4, 3, 2).reshape(B, C * kk, h * w)
    y = F.fold(o, (H, W), k, padding=pad, stride=stride).permute(0, 2, 3, 1)
    return _lin(num, y, P, name + ".proj")


def _mhsa(num, x, P, name, heads):
    B, N, C = x.shape
    d = C // heads
    q, k, v = _lin(num, x, P, name + ".qkv").reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    a = torch.softmax(torch.matmul(num.q(q), num.q(k).transpose(-1, -2)) * d ** -0.5, -1)
    o = torch.matmul(num.q(a), num.q(v)).transpose(1, 2).reshape(B, N, C)
    return _lin(num, o, P, name + ".proj")


def _class_attn(num, x, P, name, heads):
    B, N, C = x.shape
    d = C // heads
    k, v = _lin(num, x, P, name + ".kv").reshape(B, N, 2, heads, d).permute(2, 0, 3, 1, 4)
    q = _lin(num, x[:, :1], P, name + ".q").reshape(B, 1, heads, d).transpose(1, 2)
    a = torch.softmax(torch.matmul(num.q(q * d ** -0.5), num.q(k).transpose(-1, -2)), -1)
    o = torch.matmul(num.q(a), num.q(v)).transpose(1, 2).reshape(B, 1, C)
    return _lin(num, o, P, name + ".proj")


def _checkpointed(fn, x, on: bool):
    if not on:
        return fn(x)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, x, use_reentrant=False)


def forward(P: Params, images: torch.Tensor, bbox, cfg: dict, num: Numerics,
            checkpoint_blocks: bool = False):
    """Training forward on NHWC images: (class logits [B, classes], aux
    logits [B, N, classes]). `checkpoint_blocks` recomputes each block in
    the backward, which changes no value and keeps a large batch in
    memory."""
    eps_ln, eps_bn = cfg["semantics"]["layer_norm_eps"], cfg["semantics"]["batch_norm_eps"]
    heads, k = cfg["num_heads"], cfg["outlook_kernel"]
    pad, stride = cfg["outlook_padding"], cfg["outlook_stride"]
    n_out, n_tr = _split(cfg)
    x = images.permute(0, 3, 1, 2)
    for i, s in enumerate((2, 1, 1)):
        x = _conv_bn_relu(num, x, P, f"patch_embed.stem{i}", s, eps_bn)
    w = P["patch_embed.proj.weight"]
    x = F.conv2d(num.q(x), num.q(w), P["patch_embed.proj.bias"], w.shape[-1])
    x = x.permute(0, 2, 3, 1)                                          # [B, H, W, C0]
    B, H = x.shape[0], x.shape[1]
    ps = cfg["pooling_scale"]
    mask = box_mask(bbox, H // ps, ps, x.device)
    x = torch.where(mask[None, :, :, None], x.flip(0), x)

    for i in range(n_out):
        p = f"s0b{i}"

        def block(y, p=p):
            y = y + _outlook(num, _ln(y, P, p + ".norm1", eps_ln), P, p + ".attn", heads[0],
                             k, pad, stride)
            return y + _mlp(num, _ln(y, P, p + ".norm2", eps_ln), P, p + ".mlp")
        x = _checkpointed(block, x, checkpoint_blocks)
    w = P["ds0.proj.weight"]
    x = F.conv2d(num.q(x.permute(0, 3, 1, 2)), num.q(w), P["ds0.proj.bias"], w.shape[-1])
    x = x.permute(0, 2, 3, 1) + P["pos_embed"]
    g, C = x.shape[1], x.shape[3]
    x = x.reshape(B, g * g, C)
    for i in range(n_tr):
        p = f"s1b{i}"

        def block(y, p=p):
            y = y + _mhsa(num, _ln(y, P, p + ".norm1", eps_ln), P, p + ".attn", heads[-1])
            return y + _mlp(num, _ln(y, P, p + ".norm2", eps_ln), P, p + ".mlp")
        x = _checkpointed(block, x, checkpoint_blocks)
    x = torch.cat([P["cls_token"].expand(B, 1, C), x], dim=1)
    for i in range(cfg["post_layers"]):
        p = f"post{i}"
        cls = x[:, :1] + _class_attn(num, _ln(x, P, p + ".norm1", eps_ln), P, p + ".attn",
                                     heads[-1])
        cls = cls + _mlp(num, _ln(cls, P, p + ".norm2", eps_ln), P, p + ".mlp")
        x = torch.cat([cls, x[:, 1:]], dim=1)
    x = _ln(x, P, "norm", eps_ln)
    x_cls = _lin(num, x[:, 0], P, "head")
    aux = _lin(num, x[:, 1:], P, "aux_head").reshape(B, g, g, -1)
    aux = torch.where(box_mask(bbox, g, 1, x.device)[None, :, :, None], aux.flip(0), aux)
    return x_cls, aux.reshape(B, g * g, -1)
