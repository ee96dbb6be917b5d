"""Outlook attention core, counterpart of `autoprog_tpu/ops/outlook.py`.

The default (XLA) path of the JAX package: unfold -> softmax over each
window's k^2 x k^2 logits -> attend -> fold. Plain PyTorch; autograd gives
the backward. The fused kernels (K2, K3, K4) are `ops/outlook_fused.py`;
`models/layers.py` routes to K2 under AUTOPROG_FUSED_OUTLOOK=1.
"""

from __future__ import annotations

import math

import torch

from autoprog_tpu_torch.ops.unfold import fold_nhwc, unfold_nhwc


def _softmax_compute_dtype(logits: torch.Tensor, scale: float,
                           dtype: torch.dtype) -> torch.Tensor:
    """Softmax with the attention matrices stored in the compute dtype:
    scaled logits rounded to `dtype`, max subtracted there, exp and the sum
    in f32, probabilities rounded to `dtype`."""
    s = (logits.float() * scale).to(dtype)
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s.float())
    return (e / e.sum(-1, keepdim=True)).to(dtype)


def outlook_attention(v: torch.Tensor, attn_logits: torch.Tensor, *,
                      num_heads: int, kernel_size: int, stride: int,
                      padding: int, scale: float) -> torch.Tensor:
    """Apply outlook attention.

    v: projected values [B, H, W, C] (C = heads * head_dim, head-major
    channels); attn_logits: [B, h, w, heads * k^4] with h = ceil(H/stride).
    Returns [B, H, W, C] (before the output projection).

    The attend out[b,n,p,c] = sum_q attn[b,n,head(c),p,q] * patch[b,n,q,c]
    runs as a per-head [k^2, k^2] x [k^2, d] product in f32, the same sum as
    the JAX broadcast-multiply-sum with f32 accumulation."""
    B, H, W, C = v.shape
    k = kernel_size
    h, w = math.ceil(H / stride), math.ceil(W / stride)
    d = C // num_heads
    kk = k * k
    n = h * w
    patches = unfold_nhwc(v, k, stride, padding).reshape(B, n, kk, num_heads, d)
    attn = attn_logits.reshape(B, n, num_heads, kk, kk)
    attn = _softmax_compute_dtype(attn, scale, v.dtype)
    out = torch.matmul(attn.float(), patches.permute(0, 1, 3, 2, 4).float())
    out = out.to(v.dtype).permute(0, 1, 3, 2, 4).reshape(B, h, w, k, k, C)
    return fold_nhwc(out, (H, W), kernel_size=k, stride=stride, padding=padding)
