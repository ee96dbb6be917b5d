"""Fused outlook attention (K2) and the attend-only hybrids (K3, K4): CUDA
kernels and plain twins.

Counterpart of `autoprog_tpu/ops/outlook_pallas.py`. The kernels are
`csrc/outlook.cu`; its source note says what bounds them and how the design
answers it. Kernel 3, stride 2, padding 1 and even H, W are fixed (the VOLO
configuration). K2 has two routes on the card, chosen by the kernel library
from the shape: the row kernels (`outlook_fwd_rows`, `outlook_bwd_rows`:
persistent blocks that walk down runs of window rows with the next rows'
loads in flight, bf16 tiles, one backward kernel), which take every head
whose channels are whole 16-byte groups on 16-byte aligned tensors (every
VOLO outlooker), and the general kernels (a thread per channel of a quad,
a two-kernel backward) for the rest.

  outlook_attention_fused(v, logits, heads, scale)    K2: unfold, softmax,
      attend and fold in one kernel, the patches never in device memory
  outlook_attention_hybrid(v, logits, heads, scale)   K3: PyTorch unfold and
      fold around the attend kernel, channels head-minor
  outlook_attention_hybrid2(v, logits, heads, scale)  K4: the same with the
      channels head-major (no permutes around the kernel)

v is [B, H, W, C] with head-major channels, logits [B, H/2, W/2, heads * 81]
(per window and head a 9 x 9 matrix [p, q]); the result is [B, H, W, C].

Rounding points, which the twins share with the kernels: the softmax over q
of f32(logits) * scale and the attend run in f32. K2 also folds in f32 and
rounds once, to the output dtype; K3 / K4 round the attended patches once
and fold them in the working dtype. (The unfused path, `ops/outlook.py`,
rounds the scaled logits and the probabilities to the compute dtype
instead, so in bf16 it differs from these by design, as in the JAX package.)

All three share one backward (`_bwd` in the JAX package, XLA there, a kernel
here), which recomputes the softmax from the saved v and logits:
  dav = unfold(g); datt[p, q] = sum_d dav[p, (h, d)] * patch[q, (h, d)]
  ds = att * (datt - sum_q datt * att); dlogits = dt(ds * scale)
  dpatch[q, c] = dt(sum_p att[p, q] * dav[p, c]); dv = fold(dpatch) in dt

On a CUDA tensor the `torch.autograd.Function`s launch the kernels or raise:
there is no fallback. On a CPU tensor they run the plain twins below.
`LAUNCHES` counts kernel launches by the wrappers; the twins do not count.
`ROUTES` counts K2's launches by route and `PLANS` keeps the last launch of
each side as the library planned it (route, heads per block, runs per image,
threads, blocks, shared memory) with its heads (a tensor-parallel rank's
heads are its own).
"""

from __future__ import annotations

import torch

from autoprog_tpu_torch.ops.unfold import fold_nhwc, unfold_nhwc

#: kernel launches made by the wrappers: K2 forward, the shared backward,
#: the head-minor attend (K3) and the head-major attend (K4)
LAUNCHES = {"fwd": 0, "bwd": 0, "attend_hm": 0, "attend": 0}
#: K2's launches by route: the streamed row kernels or the general ones
ROUTES = {"fwd_rows": 0, "fwd_general": 0, "bwd_rows": 0, "bwd_general": 0}
#: the last K2 launch of each side, as the kernel library planned it
PLANS = {"fwd": None, "bwd": None}
_PLAN_KEYS = ("rows", "heads_per_block", "runs", "threads", "blocks", "smem")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KK = 9


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 internals; f64 stays f64 so that gradcheck can run the twins."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _softmax_q(logits: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """[B, h, w, heads * 81] -> probabilities [B, n, heads, 9, 9] (f32)."""
    B, h, w, _ = logits.shape
    att = logits.reshape(B, h * w, num_heads, _KK, _KK).to(_acc_dtype(logits))
    return torch.softmax(att * scale, dim=-1)


def _unfold_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, H, W, C] -> f32 patches [B, n, heads, 9, d]."""
    B, H, W, C = x.shape
    p = unfold_nhwc(x.to(_acc_dtype(x)), 3, 2, 1)
    return p.reshape(B, (H // 2) * (W // 2), _KK, num_heads,
                     C // num_heads).permute(0, 1, 3, 2, 4)


def outlook_attention_fused_reference(v: torch.Tensor, attn_logits: torch.Tensor,
                                      num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch forward of K2 with the kernel's rounding points."""
    B, H, W, C = v.shape
    h, w = H // 2, W // 2
    att = _softmax_q(attn_logits, num_heads, scale)
    av = torch.matmul(att, _unfold_heads(v, num_heads))       # [B, n, heads, 9, d]
    av = av.permute(0, 1, 3, 2, 4).reshape(B, h, w, 3, 3, C)
    return fold_nhwc(av, (H, W), 3, 2, 1).to(v.dtype)


def outlook_attention_backward_reference(v: torch.Tensor, attn_logits: torch.Tensor,
                                         g: torch.Tensor, num_heads: int, scale: float):
    """Plain PyTorch backward shared by K2, K3 and K4 (the kernel's formula,
    not autograd): returns (dv, dlogits)."""
    B, H, W, C = v.shape
    h, w = H // 2, W // 2
    att = _softmax_q(attn_logits, num_heads, scale)
    patches = _unfold_heads(v, num_heads)
    dav = _unfold_heads(g, num_heads)
    datt = torch.matmul(dav, patches.transpose(-1, -2))        # [B, n, heads, p, q]
    ds = att * (datt - (datt * att).sum(-1, keepdim=True))
    dlogits = (ds * scale).to(attn_logits.dtype).reshape(B, h, w, num_heads * 81)
    dpatches = torch.matmul(att.transpose(-1, -2), dav).to(v.dtype)   # [B, n, heads, q, d]
    dpatches = dpatches.permute(0, 1, 3, 2, 4).reshape(B, h, w, 3, 3, C)
    return fold_nhwc(dpatches, (H, W), 3, 2, 1), dlogits


def outlook_attend_reference(patches: torch.Tensor, att_logits: torch.Tensor,
                             num_heads: int, scale: float, head_minor: bool) -> torch.Tensor:
    """Plain PyTorch twin of the attend kernel: patches [B, n, 9, C] and
    logits [B, n, 9, 9, heads] -> [B, 9, n, C]. Channel c belongs to head
    c % heads (`head_minor`, K3) or c // d (K4)."""
    C = patches.shape[-1]
    acc = _acc_dtype(patches)
    att = torch.softmax(att_logits.to(acc) * scale, dim=3)
    c = torch.arange(C, device=patches.device)
    head_of = c % num_heads if head_minor else c // (C // num_heads)
    out = (att[..., head_of] * patches.to(acc)[:, :, None]).sum(3)     # [B, n, p, C]
    return out.permute(0, 2, 1, 3).to(patches.dtype)


# ------------------------------------------------------------------ launches


def _check_cuda(v: torch.Tensor, attn_logits: torch.Tensor, num_heads: int, what: str):
    if v.dtype not in _DTYPE_CODE or attn_logits.dtype != v.dtype:
        raise ValueError(f"{what}: v {v.dtype} and logits {attn_logits.dtype} must "
                         "share float32 or bfloat16")
    if attn_logits.device != v.device:
        raise ValueError(f"{what}: v on {v.device}, logits on {attn_logits.device}")
    if v.ndim != 4 or attn_logits.ndim != 4:
        raise ValueError(f"{what}: v must be [B, H, W, C] and logits [B, h, w, heads*81]")
    B, H, W, C = v.shape
    if H % 2 or W % 2 or C % num_heads:
        raise ValueError(f"{what}: needs even H, W and C divisible by heads, got "
                         f"{tuple(v.shape)} with {num_heads} heads")
    if tuple(attn_logits.shape) != (B, H // 2, W // 2, num_heads * 81):
        raise ValueError(f"{what}: logits {tuple(attn_logits.shape)} do not match v "
                         f"{tuple(v.shape)} with {num_heads} heads")
    if not (v.is_contiguous() and attn_logits.is_contiguous()):
        raise ValueError(f"{what}: v and logits must be contiguous")


def _count(side: str, plan, num_heads: int) -> None:
    PLANS[side] = dict(zip(_PLAN_KEYS, plan), heads=num_heads)
    ROUTES[f"{side}_{'rows' if plan[0] else 'general'}"] += 1
    LAUNCHES[side] += 1


def _launch_fwd(v, attn_logits, num_heads, scale, general: bool = False):
    """K2 forward on the card. `general` takes the general kernel at any
    shape: only `scripts/bench_k2.py`'s before / after column asks for it."""
    import ctypes
    from autoprog_tpu_torch import _build
    _check_cuda(v, attn_logits, num_heads, "outlook_fused_fwd")
    B, H, W, C = v.shape
    out = torch.empty_like(v)
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(v.device):
        rc = _build.load().outlook_fused_fwd(
            v.data_ptr(), attn_logits.data_ptr(), out.data_ptr(), B, H, W, C, num_heads,
            float(scale), _DTYPE_CODE[v.dtype], int(general), ctypes.addressof(plan),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "outlook_fused_fwd")
    _count("fwd", plan, num_heads)
    return out


def _launch_bwd(v, attn_logits, g, num_heads, scale, general: bool = False):
    """The shared backward on the card (`general` as for the forward)."""
    import ctypes
    from autoprog_tpu_torch import _build
    _check_cuda(v, attn_logits, num_heads, "outlook_fused_bwd")
    g = g.contiguous()
    if g.dtype != v.dtype or g.device != v.device or g.shape != v.shape:
        raise ValueError(f"outlook_fused_bwd: gradient {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} does not match v {tuple(v.shape)} {v.dtype} on "
                         f"{v.device}")
    B, H, W, C = v.shape
    dv, dlogits = torch.empty_like(v), torch.empty_like(attn_logits)
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(v.device):
        rc = _build.load().outlook_fused_bwd(
            v.data_ptr(), attn_logits.data_ptr(), g.data_ptr(), dv.data_ptr(),
            dlogits.data_ptr(), B, H, W, C, num_heads, float(scale), _DTYPE_CODE[v.dtype],
            int(general), ctypes.addressof(plan), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "outlook_fused_bwd")
    _count("bwd", plan, num_heads)
    return dv, dlogits


def _launch_attend(patches, att_logits, num_heads, scale, head_minor):
    from autoprog_tpu_torch import _build
    what = "outlook_attend"
    if patches.dtype not in _DTYPE_CODE or att_logits.dtype != patches.dtype:
        raise ValueError(f"{what}: patches {patches.dtype} and logits {att_logits.dtype} "
                         "must share float32 or bfloat16")
    B, n, kk, C = patches.shape
    if kk != _KK or C % num_heads or tuple(att_logits.shape) != (B, n, _KK, _KK, num_heads):
        raise ValueError(f"{what}: patches {tuple(patches.shape)} / logits "
                         f"{tuple(att_logits.shape)} are not [B, n, 9, C] / "
                         f"[B, n, 9, 9, {num_heads}]")
    if att_logits.device != patches.device:
        raise ValueError(f"{what}: patches on {patches.device}, logits on "
                         f"{att_logits.device}")
    patches, att_logits = patches.contiguous(), att_logits.contiguous()
    out = torch.empty(B, _KK, n, C, dtype=patches.dtype, device=patches.device)
    with torch.cuda.device(patches.device):
        rc = _build.load().outlook_attend(
            patches.data_ptr(), att_logits.data_ptr(), out.data_ptr(), B, n, C, num_heads,
            float(scale), int(head_minor), _DTYPE_CODE[patches.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, what)
    LAUNCHES["attend_hm" if head_minor else "attend"] += 1
    return out


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"outlook attention: unsupported device {t.device}")
    return t.device.type


def _attend(patches, att_logits, num_heads, scale, head_minor):
    if _on(patches) == "cpu":
        return outlook_attend_reference(patches, att_logits, num_heads, scale, head_minor)
    return _launch_attend(patches, att_logits, num_heads, scale, head_minor)


def _forward_hybrid(v, attn_logits, num_heads, scale):
    """K3: unfold -> head-minor channels -> attend kernel -> undo -> fold."""
    B, H, W, C = v.shape
    h, w = H // 2, W // 2
    n, d = h * w, C // num_heads
    pm = unfold_nhwc(v, 3, 2, 1).reshape(B, n, _KK, num_heads, d)
    pm = pm.permute(0, 1, 2, 4, 3).reshape(B, n, _KK, C)
    att = attn_logits.reshape(B, n, num_heads, _KK, _KK).permute(0, 1, 3, 4, 2)
    av = _attend(pm, att, num_heads, scale, True).permute(0, 2, 1, 3)   # [B, n, 9, C]
    av = av.reshape(B, n, _KK, d, num_heads).permute(0, 1, 2, 4, 3)
    return fold_nhwc(av.reshape(B, h, w, 3, 3, C), (H, W), 3, 2, 1)


def _forward_hybrid2(v, attn_logits, num_heads, scale):
    """K4: unfold -> attend kernel on the natural channel order -> fold."""
    B, H, W, C = v.shape
    h, w = H // 2, W // 2
    n = h * w
    patches = unfold_nhwc(v, 3, 2, 1).reshape(B, n, _KK, C)
    att = attn_logits.reshape(B, n, num_heads, _KK, _KK).permute(0, 1, 3, 4, 2)
    av = _attend(patches, att, num_heads, scale, False).permute(0, 2, 1, 3)
    return fold_nhwc(av.reshape(B, h, w, 3, 3, C), (H, W), 3, 2, 1)


def _save(ctx, v, attn_logits, num_heads, scale):
    ctx.save_for_backward(v, attn_logits)
    ctx.cfg = (num_heads, scale)


def _shared_backward(ctx, g):
    """The backward all three ops share (`_bwd` in the JAX package)."""
    v, attn_logits = ctx.saved_tensors
    num_heads, scale = ctx.cfg
    if _on(v) == "cpu":
        dv, dlogits = outlook_attention_backward_reference(v, attn_logits, g,
                                                           num_heads, scale)
    else:
        dv, dlogits = _launch_bwd(v, attn_logits, g, num_heads, scale)
    return dv, dlogits, None, None


class OutlookAttentionFused(torch.autograd.Function):
    """K2 with its hand-written backward."""

    @staticmethod
    def forward(ctx, v, attn_logits, num_heads: int, scale: float):
        _save(ctx, v, attn_logits, num_heads, scale)
        if _on(v) == "cpu":
            return outlook_attention_fused_reference(v, attn_logits, num_heads, scale)
        return _launch_fwd(v, attn_logits, num_heads, scale)

    backward = staticmethod(_shared_backward)


class OutlookAttentionHybrid(torch.autograd.Function):
    """K3 (head-minor attend kernel between PyTorch unfold and fold)."""

    @staticmethod
    def forward(ctx, v, attn_logits, num_heads: int, scale: float):
        _save(ctx, v, attn_logits, num_heads, scale)
        return _forward_hybrid(v, attn_logits, num_heads, scale)

    backward = staticmethod(_shared_backward)


class OutlookAttentionHybrid2(torch.autograd.Function):
    """K4 (head-major attend kernel between PyTorch unfold and fold)."""

    @staticmethod
    def forward(ctx, v, attn_logits, num_heads: int, scale: float):
        _save(ctx, v, attn_logits, num_heads, scale)
        return _forward_hybrid2(v, attn_logits, num_heads, scale)

    backward = staticmethod(_shared_backward)


def outlook_attention_fused(v: torch.Tensor, attn_logits: torch.Tensor, num_heads: int,
                            scale: float) -> torch.Tensor:
    """Fused outlook attention, K2 (see the module docstring)."""
    return OutlookAttentionFused.apply(v, attn_logits, num_heads, scale)


def outlook_attention_hybrid(v: torch.Tensor, attn_logits: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """PyTorch unfold/fold around the head-minor attend kernel, K3."""
    return OutlookAttentionHybrid.apply(v, attn_logits, num_heads, scale)


def outlook_attention_hybrid2(v: torch.Tensor, attn_logits: torch.Tensor, num_heads: int,
                              scale: float) -> torch.Tensor:
    """PyTorch unfold/fold around the head-major attend kernel, K4."""
    return OutlookAttentionHybrid2.apply(v, attn_logits, num_heads, scale)
