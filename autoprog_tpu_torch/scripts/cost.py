"""The card's peaks and the work of each hand-written kernel of the train
step, in one place for every reader of a bound or a floor: `chip_smoke.py`'s
kernel report (`bound_ms`), `scripts/bench_k2.py` and `scripts/bench_roofline.py`,
so that a bound and the roofline count the same work whatever runs the op.

The peaks are NVIDIA's published dense rates of one H100 SXM at its full
700 W: 3.35 TB/s of HBM, 989 TFLOP/s of bf16 on the tensor cores and
67 TFLOP/s of plain f32 (TF32 is off in the port).

A kernel's work is (FLOP, bytes) at a shape: bytes count every input read
once and every output written once; operations count what the function
needs (2 per multiply-add).
"""

from __future__ import annotations

from typing import Tuple

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
#: peak FLOP/s by the name of the operands' dtype (fp16 shares bf16's)
PEAKS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "float32": F32_FLOPS}


def least_ms(nbytes: float, flops: float, peak: float) -> Tuple[float, str]:
    """(least ms, what sets it): the bytes over the HBM rate against the
    operations over the peak of their type."""
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_work(side: str, B: int, n: int, heads: int, head_dim: int,
            item: int = 2) -> Tuple[float, float]:
    """K1 (`mhsa_fused_qkv`) on [B, n, 3 C] qkv, C = heads x head_dim, at the
    peak of its operands' type: 2 n^2 d FLOP a product and head, two products
    forward (scores, attend) and five backward (the scores recomputed, dP,
    dV, dQ, dK); the forward reads qkv and writes out, the backward reads
    qkv and dout and writes dqkv."""
    C = heads * head_dim
    prod = 2 * n * n * head_dim * heads * B
    if side == "fwd":
        return 2 * prod, 4 * B * n * C * item
    return 5 * prod, 7 * B * n * C * item


def k2_work(side: str, B: int, H: int, W: int, C: int, heads: int,
            item: int = 2) -> Tuple[float, float]:
    """K2 (`outlook_attention_fused`) on v [B, H, W, C] with 3x3 windows at
    stride 2, in f32 arithmetic (`F32_FLOPS`): 81 multiply-adds per window,
    head and channel of the head forward, twice that backward; the forward
    reads v and the logits and writes out, the backward reads v, the logits
    and g and writes dv and dlogits."""
    n = (H // 2) * (W // 2)
    map_b, log_b = B * H * W * C * item, B * n * heads * 81 * item
    flops = 2 * B * n * 81 * C
    if side == "fwd":
        return flops, 2 * map_b + log_b
    return 2 * flops, 3 * map_b + 2 * log_b
