"""Outlook attention core, counterpart of `autoprog_tpu/ops/outlook.py`.

The default (XLA) path of the JAX package: unfold -> softmax over each
window's k^2 x k^2 logits -> attend -> fold. Plain PyTorch; autograd gives
the backward. The fused kernels (K2, K3, K4) are `ops/outlook_fused.py`;
`models/layers.py` routes to K2 under AUTOPROG_FUSED_OUTLOOK=1.

Beside it, the JAX package's two other formulations, which only
`scripts/bench_outlook.py` runs: the attend as a block-diagonal matmul over
`group` tokens (`outlook_attention_blockdiag`), and the op with the
hand-written backward (`outlook_attention_cvjp`).
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


def outlook_attention_blockdiag(v: torch.Tensor, attn_logits: torch.Tensor, *,
                                num_heads: int, kernel_size: int, stride: int,
                                padding: int, scale: float, group: int = 7) -> torch.Tensor:
    """`outlook_attention` with the attend as one block-diagonal matmul per
    `group` tokens and head: the [g k^2, g k^2] matrix holds each token's
    k^2 x k^2 attention on its diagonal and zeros elsewhere (g times the
    attention's size), against the g tokens' stacked patches. The product
    accumulates in f32, as the JAX einsum does. Falls back to
    `outlook_attention` where `group` does not divide the token count."""
    B, H, W, C = v.shape
    k = kernel_size
    h, w = math.ceil(H / stride), math.ceil(W / stride)
    d = C // num_heads
    kk = k * k
    n = h * w
    g = group
    if n % g:
        return outlook_attention(v, attn_logits, num_heads=num_heads, kernel_size=k,
                                 stride=stride, padding=padding, scale=scale)
    m = n // g
    patches = unfold_nhwc(v, k, stride, padding)                  # [B, h, w, k, k, C]
    attn = attn_logits.reshape(B, n, num_heads, kk, kk)
    attn = _softmax_compute_dtype(attn, scale, v.dtype)
    # A[b, m, hd, t kk + p, t' kk + q] = attn[b, m g + t, hd, p, q] * (t == t')
    eye = torch.eye(g, dtype=attn.dtype, device=attn.device)
    A = attn.reshape(B, m, g, num_heads, kk, kk).permute(0, 1, 3, 2, 4, 5)
    A = A[:, :, :, :, :, None, :] * eye[:, None, :, None]         # [B, m, hd, g, p, g', q]
    A = A.reshape(B, m, num_heads, g * kk, g * kk)
    P = patches.reshape(B, m, g, kk, num_heads, d)
    P = P.permute(0, 1, 4, 2, 3, 5).reshape(B, m, num_heads, g * kk, d)
    O = torch.matmul(A.float(), P.float()).to(v.dtype)
    O = O.reshape(B, m, num_heads, g, kk, d).permute(0, 1, 3, 4, 2, 5)
    return fold_nhwc(O.reshape(B, h, w, k, k, C), (H, W), kernel_size=k, stride=stride,
                     padding=padding)


class _OutlookCvjp(torch.autograd.Function):
    """`outlook_attention` forward; the JAX package's hand-written backward
    (`_outlook_cvjp_bwd`), which recomputes the patches and the softmax from
    the saved inputs."""

    @staticmethod
    def forward(ctx, v, attn_logits, num_heads, kernel_size, stride, padding, scale):
        ctx.save_for_backward(v, attn_logits)
        ctx.geometry = (num_heads, kernel_size, stride, padding, scale)
        return outlook_attention(v, attn_logits, num_heads=num_heads, kernel_size=kernel_size,
                                 stride=stride, padding=padding, scale=scale)

    @staticmethod
    def backward(ctx, g):
        v, attn_logits = ctx.saved_tensors
        num_heads, k, stride, padding, scale = ctx.geometry
        B, H, W, C = v.shape
        h, w = math.ceil(H / stride), math.ceil(W / stride)
        d = C // num_heads
        n = h * w
        kk = k * k
        patches = unfold_nhwc(v, k, stride, padding).reshape(B, n, kk, C)
        attn = attn_logits.reshape(B, n, num_heads, kk, kk)
        attn = _softmax_compute_dtype(attn, scale, v.dtype)       # [B, n, h, p, q]
        # fold's adjoint is unfold with the same geometry
        dav = unfold_nhwc(g, k, stride, padding).reshape(B, n, kk, C)
        # d_attn[b, n, h, p, q] = sum_d dav[b, n, p, (h, d)] * patches[b, n, q, (h, d)]
        datt = torch.einsum("bnphd,bnqhd->bnhpq", dav.reshape(B, n, kk, num_heads, d).float(),
                            patches.reshape(B, n, kk, num_heads, d).float())
        af = attn.float()
        ds = af * (datt - (datt * af).sum(-1, keepdim=True))
        dlogits = (ds * scale).to(attn_logits.dtype).reshape(B, h, w, num_heads * kk * kk)
        # d_patches: the forward's sum with (p, q) swapped and dav for the patches
        at_c = attn.permute(0, 1, 3, 4, 2).repeat_interleave(d, dim=-1)   # [B, n, p, q, C]
        dpatches = (at_c * dav[:, :, :, None].to(at_c.dtype)).sum(2, dtype=torch.float32)
        dpatches = dpatches.to(v.dtype)
        dv = fold_nhwc(dpatches.reshape(B, h, w, k, k, C), (H, W), kernel_size=k,
                       stride=stride, padding=padding)
        return dv, dlogits, None, None, None, None, None


def outlook_attention_cvjp(v: torch.Tensor, attn_logits: torch.Tensor, *, num_heads: int,
                           kernel_size: int, stride: int, padding: int,
                           scale: float) -> torch.Tensor:
    """`outlook_attention` with the JAX package's hand-written backward."""
    return _OutlookCvjp.apply(v, attn_logits, num_heads, kernel_size, stride, padding, scale)
