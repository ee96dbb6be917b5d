"""The yardstick's arithmetic: the card's peaks, the work of the two
hand-written kernels at a shape, and the train FLOP of a configuration.

The peaks and `k1_work` / `k2_work` are frozen copies of the program's
`scripts/cost.py` as it stood when the benchmark was written: a change to
the program cannot move them. Peaks are NVIDIA's published dense rates of
one H100 SXM at its full 700 W: 3.35 TB/s of HBM, 989 TFLOP/s of bf16 on the
tensor cores, 67 TFLOP/s of plain f32.

A kernel's work is (FLOP, bytes) at a shape: bytes count every input read
once and every output written once; operations count what the function
needs (2 per multiply-add).
"""

from __future__ import annotations

import math
from typing import List, Tuple

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def least_s(flops: float, nbytes: float, peak: float) -> float:
    """The least seconds a call of work (flops, nbytes) can take: bytes over
    the HBM rate or operations over the peak, whichever is longer."""
    return max(nbytes / HBM_BPS, flops / peak)


def k1_work(side: str, B: int, n: int, heads: int, head_dim: int,
            item: int = 2) -> Tuple[float, float]:
    """K1 (fused multi-head self-attention on a packed [B, n, 3 C] qkv):
    2 n^2 d FLOP a product and head, two products forward (scores, attend)
    and five backward (scores recomputed, dP, dV, dQ, dK); the forward reads
    qkv and writes out, the backward reads qkv and dout and writes dqkv.
    Its peak is bf16's."""
    C = heads * head_dim
    prod = 2 * n * n * head_dim * heads * B
    if side == "fwd":
        return 2 * prod, 4 * B * n * C * item
    return 5 * prod, 7 * B * n * C * item


def k2_work(side: str, B: int, H: int, W: int, C: int, heads: int,
            item: int = 2) -> Tuple[float, float]:
    """K2 (fused outlook attention) on v [B, H, W, C] with 3x3 windows at
    stride 2, in f32 arithmetic (its peak is `F32_FLOPS`): 81 multiply-adds
    per window, head and channel of the head forward, twice that backward;
    the forward reads v and the logits and writes out, the backward reads
    v, the logits and g and writes dv and dlogits."""
    n = (H // 2) * (W // 2)
    map_b, log_b = B * H * W * C * item, B * n * heads * 81 * item
    flops = 2 * B * n * 81 * C
    if side == "fwd":
        return flops, 2 * map_b + log_b
    return 2 * flops, 3 * map_b + 2 * log_b


def mhsa_shapes(cfg: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(B, n, heads, head_dim) of every self-attention block of one step."""
    if cfg["family"] == "volo":
        g = cfg["img_size"] // cfg["patch_size"] // cfg["pooling_scale"]
        C, h = cfg["embed_dims"][-1], cfg["num_heads"][-1]
        return [(batch, g * g, h, C // h)] * sum(cfg["layers"][1:])
    n = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    C, h = cfg["embed_dim"], cfg["num_heads"]
    return [(batch, n, h, C // h)] * cfg["depth"]


def outlook_shapes(cfg: dict, batch: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, H, W, C, heads) of the value map of every outlooker of one step."""
    if cfg["family"] != "volo":
        return []
    g = cfg["img_size"] // (cfg["patch_size"] // 2) // 2
    return [(batch, g, g, cfg["embed_dims"][0], cfg["num_heads"][0])] * cfg["layers"][0]


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward: every linear layer,
    convolution and attention product, nothing else."""
    if cfg["family"] == "volo":
        return _volo_macs(cfg)
    if cfg["family"] == "deit":
        return _deit_macs(cfg)
    raise ValueError(f"no FLOP formula for family {cfg['family']!r}")


def train_flops_per_image(cfg: dict) -> float:
    """3x the forward's FLOP (forward, and the backward's two products per
    forward product); recomputation is not counted."""
    return 3 * 2 * forward_macs(cfg)


def _mlp(tokens: int, c: int, ratio: float) -> int:
    return 2 * tokens * c * int(c * ratio)


def _mhsa_block(tokens: int, c: int, ratio: float) -> int:
    return (tokens * c * 3 * c + 2 * tokens * tokens * c + tokens * c * c
            + _mlp(tokens, c, ratio))


def _volo_macs(cfg: dict) -> int:
    r, hid, p = cfg["img_size"], cfg["stem_hidden_dim"], cfg["patch_size"]
    c0, c1 = cfg["embed_dims"][0], cfg["embed_dims"][-1]
    heads0, k, s = cfg["num_heads"][0], cfg["outlook_kernel"], cfg["outlook_stride"]
    mlp = cfg["mlp_ratios"]
    m = r // 2                                   # the stem's map
    macs = m * m * hid * 3 * 49 + 2 * m * m * hid * hid * 9
    g0 = r // p                                  # the outlookers' map
    macs += g0 * g0 * c0 * hid * (p // 2) ** 2
    h0 = math.ceil(g0 / s)
    outlooker = (g0 * g0 * c0 * c0                          # v
                 + h0 * h0 * c0 * k ** 4 * heads0            # attention logits
                 + h0 * h0 * k ** 4 * c0                     # attend
                 + g0 * g0 * c0 * c0                         # proj
                 + _mlp(g0 * g0, c0, mlp[0]))
    macs += cfg["layers"][0] * outlooker
    g1 = g0 // 2
    n = g1 * g1
    macs += n * c1 * c0 * 4                                 # downsample
    macs += sum(cfg["layers"][1:]) * _mhsa_block(n, c1, mlp[-1])
    post = ((n + 1) * c1 * 2 * c1 + c1 * c1                 # kv over all tokens, q
            + 2 * (n + 1) * c1 + c1 * c1 + _mlp(1, c1, mlp[-1]))
    macs += cfg["post_layers"] * post
    return macs + c1 * cfg["num_classes"] * (1 + n)        # head, aux head


def _deit_macs(cfg: dict) -> int:
    r, p, c = cfg["img_size"], cfg["patch_size"], cfg["embed_dim"]
    n = (r // p) ** 2
    macs = n * c * 3 * p * p
    macs += cfg["depth"] * _mhsa_block(n + 1, c, cfg["mlp_ratio"])
    return macs + c * cfg["num_classes"]
