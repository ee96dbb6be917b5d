"""Schedule variants of K1's forward, counterpart of the JAX package's
`scripts/attn_variants.py` (`mhsa_fwd_variant`, `mhsa_variant_with_shared_bwd`).

K1's first forward (the streaming cells of `csrc/mhsa_common.cuh`, still its
path above n = 256; `loop_img1` of `bench_attn_x`) keeps no score row: it
computes the scores of a tile twice, once for the row maxima and once for the
softmax and the product with V. The variants put the alternatives beside it,
in `csrc/mhsa_variants.cu` (bf16 only, same contract as `mhsa_fused_qkv`:
qkv [B, n, 3C] -> [B, n, C]); what they measured is what K1's resident path
was then built from:

  * twophase        every score of the block's rows is computed once and
                    parked in shared memory at f32; softmax and T(e) . V read
                    the parked rows back;
  * twophase_bf16s  the same, parked at bf16 (half the shared memory): K1's
                    default numerics, where twophase has f32 scores;
  * pipelined       K1's two loops with the next K (and V) tile fetched by
                    cp.async into a second buffer while the tensor cores work
                    on the current one; f32 scores.

None changes the math, so the plain twin of a variant is K1's twin at the
variant's score type. On the card a variant with f32 scores equals the first
K1 schedule (`loop_img1`) bit for bit and K1 to 2 ulp of bf16.
A shape whose parked rows do not fit a block's shared memory (n = 1024 at
f32) and, for `pipelined`, a head_dim that is not a multiple of 8 are refused
with ValueError. `LAUNCHES` counts kernel launches per variant.
"""

from __future__ import annotations

import torch

from autoprog_tpu_torch.ops import attention as A

#: variant name -> the code `mhsa_variant_fwd` takes
_KERNELS = {"twophase": 0, "twophase_bf16s": 1, "pipelined": 2}
#: the score type of each variant: K1 at this `scores_f32` computes the same
SCORES_F32 = {"twophase": True, "twophase_bf16s": False, "pipelined": True}
#: kernel launches per variant (plain twins are not counted)
LAUNCHES = {name: 0 for name in _KERNELS}


def mhsa_fwd_variant_reference(name: str, qkv: torch.Tensor, num_heads: int,
                               scale: float) -> torch.Tensor:
    """Plain twin: K1's twin at the variant's score type."""
    return A.mhsa_fused_qkv_reference(qkv, num_heads, scale, SCORES_F32[name])


def check_bf16_qkv(what: str, qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the variant kernels take bfloat16, got {qkv.dtype}")
    A._check_cuda(qkv, num_heads)


def _launch(name: str, qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    from autoprog_tpu_torch import _build
    check_bf16_qkv(f"mhsa_fwd_variant({name})", qkv, num_heads)
    B, n, C3 = qkv.shape
    out = torch.empty(B, n, C3 // 3, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _build.load().mhsa_variant_fwd(
            qkv.data_ptr(), out.data_ptr(), B, n, C3 // 3, num_heads, float(scale),
            _KERNELS[name], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"mhsa_variant_fwd({name})")
    LAUNCHES[name] += 1
    return out


def mhsa_fwd_variant(name: str, qkv: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """Forward-only variant call, same contract as mhsa_fused_qkv."""
    if name not in _KERNELS:
        raise KeyError(f"unknown variant {name!r}; one of {sorted(_KERNELS)}")
    if A._on(qkv) == "cpu":
        return mhsa_fwd_variant_reference(name, qkv, num_heads, scale)
    return _launch(name, qkv, num_heads, scale)


def mhsa_variant_with_shared_bwd(name: str):
    """Variant forward + K1's backward kernel, for forward + backward timing
    (only the forward is under test). As in the JAX script, the backward runs
    at K1's default score type (AUTOPROG_ATTN_SCORES_F32)."""
    if name not in _KERNELS:
        raise KeyError(f"unknown variant {name!r}; one of {sorted(_KERNELS)}")

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, num_heads: int, scale: float):
            ctx.save_for_backward(qkv)
            ctx.cfg = (num_heads, scale)
            return mhsa_fwd_variant(name, qkv, num_heads, scale)

        @staticmethod
        def backward(ctx, dout):
            (qkv,) = ctx.saved_tensors
            num_heads, scale = ctx.cfg
            sf = A.scores_f32_default()
            if A._on(qkv) == "cpu":
                dqkv = A.mhsa_fused_qkv_backward_reference(qkv, dout, num_heads, scale, sf)
            else:
                dqkv = A._launch_bwd(qkv, dout, num_heads, scale, sf)
            return dqkv, None, None

    return Fn.apply
