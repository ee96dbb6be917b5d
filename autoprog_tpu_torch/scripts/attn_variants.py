"""Schedule variants of K1's forward, counterpart of the JAX package's
`scripts/attn_variants.py` (`mhsa_fwd_variant`, `mhsa_variant_with_shared_bwd`).

The kernels are in `csrc/mhsa_variants.cu` (bf16 only, same contract as
`mhsa_fused_qkv`: qkv [B, n, 3C] -> [B, n, C]). Each asks K1 one question of
schedule and keeps the rest of K1's design; at the resident shapes (n <= 256,
head_dim <= 64) they are built from K1's resident walks:

  * twophase        park or recompute? One q k^T sweep; each warp's masked
                    score rows are parked in shared memory at f32, and exp, z
                    and T(e) . V read them back where K1 computes them again;
  * twophase_bf16s  the same, parked at bf16 (half the shared memory), at
                    K1's default numerics;
  * pipelined       K1's forward with the next work item always in flight in
                    a second buffer (K1 takes one only where it costs no
                    residency); f32 scores.

None changes the math, so the plain twin of a variant is K1's twin at the
variant's score type, and on the card a variant equals K1 at that score type
bit for bit (`A._launch_fwd(qkv, H, scale, SCORES_F32[name])`). Above the
resident shapes they run the streaming cells, K1's path there, and the f32
ones equal `loop_img1` of `bench_attn_x` bit for bit. A shape whose parked
rows do not fit a block's shared memory (n = 1024 at f32) and, for
`pipelined`, a head_dim that is not a multiple of 8 are refused with
ValueError. `LAUNCHES` counts the wrapper's launches per variant; `RAN`
counts them per (variant, the kernels the call launched), as the library
itself counts each kernel beside its launch (`kernel_launches`).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch

from autoprog_tpu_torch.ops import attention as A

#: variant name -> the code `mhsa_variant_fwd` takes
_KERNELS = {"twophase": 0, "twophase_bf16s": 1, "pipelined": 2}
#: the score type of each variant: K1 at this `scores_f32` computes the same
SCORES_F32 = {"twophase": True, "twophase_bf16s": False, "pipelined": True}
#: kernel launches per variant (plain twins are not counted)
LAUNCHES = {name: 0 for name in _KERNELS}
#: launches per (variant, "+"-joined names of the kernels the call launched)
RAN: "collections.Counter[tuple]" = collections.Counter()
#: the kernels of `csrc/mhsa_variants.cu` in the order of its `Kernel` enum:
#: the streaming ones, then the resident ones
KERNEL_NAMES = ("fwd_twophase", "fwd_pipelined", "group_fwd_loop", "group_fwd_phase",
                "group_bwd_dq_loop", "group_bwd_dkv_loop", "group_bwd_dq_phase",
                "group_bwd_dkv_phase", "fwd_walk", "fwd_park", "fwd_phase", "bwd_walk")


#: the kernels one call launches, at the resident shapes and where the shape
#: streams, as `RAN` names them; S1's calls by "<order>_fwd" / "<order>_bwd"
KERNELS_BY_ROUTE = {
    "twophase": ("fwd_park", "fwd_twophase"),
    "twophase_bf16s": ("fwd_park", "fwd_twophase"),
    "pipelined": ("fwd_walk", "fwd_pipelined"),
    "loop_fwd": ("fwd_walk", "group_fwd_loop"),
    "phase_fwd": ("fwd_phase", "group_fwd_phase"),
    "loop_bwd": ("bwd_walk", "group_bwd_dq_loop+group_bwd_dkv_loop"),
    "phase_bwd": ("bwd_walk", "group_bwd_dq_phase+group_bwd_dkv_phase"),
}


def expected_kernels(key: str, resident: bool) -> str:
    """What one call of `key` (a variant, or S1's "<order>_img<G>_fwd" /
    "..._bwd") should launch at a resident shape or at a streaming one."""
    if key not in KERNELS_BY_ROUTE:
        key = f"{key.split('_')[0]}_{key.rsplit('_', 1)[1]}"
    return KERNELS_BY_ROUTE[key][0 if resident else 1]


def kernel_launches(lib) -> tuple:
    """Launches of each kernel of `csrc/mhsa_variants.cu` so far, in
    KERNEL_NAMES' order, as the library counts them beside each launch."""
    counts = (ctypes.c_longlong * len(KERNEL_NAMES))()
    got = lib.mhsa_variant_launches(counts, len(counts))
    if got != len(KERNEL_NAMES):
        raise RuntimeError(f"mhsa_variant_launches counts {got} kernels, KERNEL_NAMES names "
                           f"{len(KERNEL_NAMES)}")
    return tuple(counts)


def launched(lib, before: Sequence[int]) -> str:
    """The kernels launched since `before` (a `kernel_launches` reading),
    "+"-joined."""
    after = kernel_launches(lib)
    ran = [name for name, a, b in zip(KERNEL_NAMES, before, after) if b > a]
    if not ran:
        raise RuntimeError("the variant's entry point returned 0 and launched no kernel")
    return "+".join(ran)


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
    lib = _build.load()
    before = kernel_launches(lib)
    with torch.cuda.device(qkv.device):
        rc = lib.mhsa_variant_fwd(
            qkv.data_ptr(), out.data_ptr(), B, n, C3 // 3, num_heads, float(scale),
            _KERNELS[name], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"mhsa_variant_fwd({name})")
    LAUNCHES[name] += 1
    RAN[name, launched(lib, before)] += 1
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
