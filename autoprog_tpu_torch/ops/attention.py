"""Fused MHSA: on the raw qkv projection (K1) and on separate q, k, v (K5);
CUDA kernels and plain twins.

Counterpart of `autoprog_tpu/ops/attention_pallas.py` (`mhsa_fused_qkv`,
`mhsa_fused`). The kernels are `csrc/mhsa_qkv.cu`; their source note says
what bounds them and how the design answers it. Which kernels run is decided
by type and shape alone: bf16 with n <= 256 and head_dim <= 64 takes the
resident path (K and V of an (image, head) held in shared memory, loaded by
cp.async; a warp walks them for its 16 query rows; the backward is one
kernel per cell); bf16 above that (n up to 1024, head_dim up to 128) streams
K and V in tiles, and f32 runs scalar kernels, both with a backward of two
kernels.

`mhsa_fused_qkv(qkv, num_heads, scale)` takes qkv [B, n, 3C] in the channel
order (3, heads, d) of the qkv Dense and returns [B, n, C]. On a CUDA tensor
`MhsaFusedQkv` launches the kernels (or raises: there is no fallback); on a
CPU tensor it runs the plain twins below, which round at exactly the points
the Pallas kernel does:

  qs = dt(f32(q) * scale); S = qs . k^T in f32, rounded to the score dtype
  (dt, or f32 with AUTOPROG_ATTN_SCORES_F32=1); e = exp(S - rowmax), z =
  rowsum(e); O = (dt(e) . v) / z -- the unnormalised e is rounded to dt
  before the product and the division comes after.

The backward recomputes p = softmax(f32(S)) at the forward's score dtype:
dV = dt(p)^T . dO, dP = dO . v^T, dS = dt(p * (dP - rowsum(dP * p))),
dQ = (dS . k) * scale, dK = dS^T . qs, written into one [B, n, 3C] grad.

When a backward will follow, the forward also returns the row statistics
`stats` [B, heads, n, 2] f32, (rowmax(S), z) per query row; the autograd
Functions save them and the backward takes p = exp(S - rowmax) / z from
them instead of reducing the rows again (the same bits: both are the
forward's own values). A backward without statistics computes them itself.

`mhsa_fused(q, k, v, scale)` is the same function on separate q, k, v of
shape [B, n, heads, d] with the scores always f32, returning
[B, n, heads, d]. The kernel reads each operand in place by its strides (a
contiguous tensor or, say, one of the three views of a [B, n, 3, heads, d]
buffer); only the last axis must be contiguous, and nothing is copied or
transposed on the way in. Its gradients are three contiguous tensors.

`LAUNCHES` counts kernel launches by the wrappers ("fwd", "bwd" for K1,
"fused_fwd", "fused_bwd" for K5), `SHAPE_LAUNCHES` K1's per (side, tokens,
head_dim); the twins do not count.
"""

from __future__ import annotations

import collections
import os

import torch

#: kernel launches made by MhsaFusedQkv and MhsaFused (plain twins are not
#: counted)
LAUNCHES = {"fwd": 0, "bwd": 0, "fused_fwd": 0, "fused_bwd": 0}
#: the same launches of K1 per ("fwd" or "bwd", tokens, head_dim)
SHAPE_LAUNCHES: "collections.Counter[tuple]" = collections.Counter()

#: the router's limits (`autoprog_tpu/models/layers.py:_use_fused_attn`)
MAX_TOKENS = 1024
MAX_HEAD_DIM = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def scores_f32_default() -> bool:
    return os.environ.get("AUTOPROG_ATTN_SCORES_F32", "0") == "1"


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """[B, n, 3C] -> q, k, v as [B, heads, n, d] views."""
    B, n, C3 = qkv.shape
    d = C3 // 3 // num_heads
    return qkv.view(B, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, heads, n, d] -> [B, n, heads * d]."""
    B, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, n, h * d)


def _scores(qs, k, sdt):
    """S = qs . k^T accumulated in f32 and rounded to the score dtype."""
    return torch.matmul(qs.float(), k.float().transpose(-1, -2)).to(sdt).float()


def _exp_and_stats(s):
    """e = exp(S - rowmax), and (rowmax, z) stacked as [..., n, 2]."""
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(-1, keepdim=True)
    return e, z, torch.cat([m, z], -1)


def _probs_from_stats(s, stats):
    """p = exp(S - rowmax) / z from saved (rowmax, z), or from the rows."""
    if stats is None:
        e, z, _ = _exp_and_stats(s)
    else:
        e, z = torch.exp(s - stats[..., :1]), stats[..., 1:]
    return e / z


def _attend(qs, k, v, sdt, dt):
    """O = (dt(e) . v) / z as [B, heads, n, d] in dt, and the statistics."""
    e, z, stats = _exp_and_stats(_scores(qs, k, sdt))
    return (torch.matmul(e.to(dt).float(), v.float()) / z).to(dt), stats


def _attend_backward(qs, k, v, do, sdt, dt, scale, stats):
    """dq, dk, dv as f32 [B, heads, n, d] (the kernel's formula, not autograd)."""
    p = _probs_from_stats(_scores(qs, k, sdt), stats)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    return dq, dk, dv


def mhsa_fused_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float,
                             scores_f32: bool = False, return_stats: bool = False):
    """Plain PyTorch forward of K1 with the kernel's rounding points; with
    `return_stats` also the row statistics [B, heads, n, 2]."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    qs = (q.float() * scale).to(dt)
    o, stats = _attend(qs, k, v, torch.float32 if scores_f32 else dt, dt)
    out = _merge_heads(o)
    return (out, stats) if return_stats else out


def mhsa_fused_qkv_backward_reference(qkv: torch.Tensor, dout: torch.Tensor,
                                      num_heads: int, scale: float,
                                      scores_f32: bool = False,
                                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch backward of K1 (the kernel's formula, not autograd);
    `stats` are the forward's row statistics, if it kept them."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    B, n, C = dout.shape
    do = dout.view(B, n, num_heads, C // num_heads).permute(0, 2, 1, 3).float()
    qs = (q.float() * scale).to(dt)
    grads = torch.stack(_attend_backward(
        qs, k, v, do, torch.float32 if scores_f32 else dt, dt, scale, stats))
    return grads.permute(1, 3, 0, 2, 4).reshape(B, n, 3 * C).to(dt)  # from [3, B, h, n, d]


def _check_cuda(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"mhsa_fused_qkv: dtype {qkv.dtype} not supported "
                         "(float32 or bfloat16)")
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"mhsa_fused_qkv: qkv must be [B, n, 3C], got "
                         f"{tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("mhsa_fused_qkv: qkv must be contiguous")
    B, n, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads:
        raise ValueError(f"mhsa_fused_qkv: C={C} not divisible by {num_heads} heads")
    if not (1 <= n <= MAX_TOKENS) or C // num_heads > MAX_HEAD_DIM or B > 65535:
        raise ValueError(
            f"mhsa_fused_qkv: shape B={B}, n={n}, head_dim={C // num_heads} "
            f"outside the kernel's limits (n <= {MAX_TOKENS}, head_dim <= "
            f"{MAX_HEAD_DIM}, B <= 65535)")


def _check_stats(what: str, stats, like: torch.Tensor, B: int, heads: int, n: int):
    if stats is None:
        return None
    if (stats.dtype != torch.float32 or stats.device != like.device
            or tuple(stats.shape) != (B, heads, n, 2) or not stats.is_contiguous()):
        raise ValueError(f"{what}: stats must be contiguous float32 "
                         f"{(B, heads, n, 2)} on {like.device}, got "
                         f"{tuple(stats.shape)} {stats.dtype} on {stats.device}")
    return stats.data_ptr()


def _scratch(lib, like: torch.Tensor, B: int, heads: int, n: int, d: int):
    """What the two-kernel backwards pass their row statistics through; the
    resident path needs none."""
    if not lib.mhsa_uses_scratch(n, d, _DTYPE_CODE[like.dtype]):
        return None
    return torch.empty(B * heads * n * 3, dtype=torch.float32, device=like.device)


def _launch_fwd(qkv, num_heads, scale, scores_f32, want_stats: bool = False):
    """K1's forward kernel: out, or (out, stats) with `want_stats`."""
    from autoprog_tpu_torch import _build
    _check_cuda(qkv, num_heads)
    B, n, C3 = qkv.shape
    out = torch.empty(B, n, C3 // 3, dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty(B, num_heads, n, 2, dtype=torch.float32,
                        device=qkv.device) if want_stats else None
    with torch.cuda.device(qkv.device):
        rc = _build.load().mhsa_qkv_fwd(
            qkv.data_ptr(), out.data_ptr(), None if stats is None else stats.data_ptr(),
            B, n, C3 // 3, num_heads, float(scale), int(scores_f32),
            _DTYPE_CODE[qkv.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_qkv_fwd")
    LAUNCHES["fwd"] += 1
    SHAPE_LAUNCHES["fwd", n, C3 // 3 // num_heads] += 1
    return (out, stats) if want_stats else out


def _launch_bwd(qkv, dout, num_heads, scale, scores_f32, stats=None):
    """K1's backward kernels; `stats` as the forward returned them, or None."""
    from autoprog_tpu_torch import _build
    _check_cuda(qkv, num_heads)
    B, n, C3 = qkv.shape
    dout = dout.contiguous()
    if (dout.dtype != qkv.dtype or dout.device != qkv.device
            or tuple(dout.shape) != (B, n, C3 // 3)):
        raise ValueError(f"mhsa_fused_qkv backward: dout {tuple(dout.shape)} "
                         f"{dout.dtype} on {dout.device} does not match qkv "
                         f"{tuple(qkv.shape)} {qkv.dtype} on {qkv.device}")
    stats_ptr = _check_stats("mhsa_fused_qkv backward", stats, qkv, B, num_heads, n)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        lib = _build.load()
        scratch = _scratch(lib, qkv, B, num_heads, n, C3 // 3 // num_heads)
        rc = lib.mhsa_qkv_bwd(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats_ptr,
            None if scratch is None else scratch.data_ptr(),
            B, n, C3 // 3, num_heads, float(scale), int(scores_f32),
            _DTYPE_CODE[qkv.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_qkv_bwd")
    LAUNCHES["bwd"] += 1
    SHAPE_LAUNCHES["bwd", n, C3 // 3 // num_heads] += 1
    return dqkv


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused MHSA: unsupported device {t.device}")
    return t.device.type


class MhsaFusedQkv(torch.autograd.Function):
    """K1 with its hand-written backward (the Pallas op's custom_vjp). The
    forward keeps the row statistics for the backward when one will follow."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, scores_f32: bool):
        ctx.cfg = (num_heads, scale, scores_f32)
        want = ctx.needs_input_grad[0]
        if _on(qkv) == "cpu":
            res = mhsa_fused_qkv_reference(qkv, num_heads, scale, scores_f32, want)
        else:
            res = _launch_fwd(qkv, num_heads, scale, scores_f32, want)
        out, stats = res if want else (res, None)
        ctx.save_for_backward(qkv, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, stats = ctx.saved_tensors
        num_heads, scale, scores_f32 = ctx.cfg
        if _on(qkv) == "cpu":
            dqkv = mhsa_fused_qkv_backward_reference(qkv, dout, num_heads,
                                                     scale, scores_f32, stats)
        else:
            dqkv = _launch_bwd(qkv, dout, num_heads, scale, scores_f32, stats)
        return dqkv, None, None, None


def mhsa_fused_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                   scores_f32: bool | None = None) -> torch.Tensor:
    """Fused MHSA: [B, n, 3C] qkv -> [B, n, C] (see module docstring).

    `scores_f32` defaults to AUTOPROG_ATTN_SCORES_F32, as in the JAX op."""
    sf = scores_f32_default() if scores_f32 is None else scores_f32
    return MhsaFusedQkv.apply(qkv, num_heads, scale, sf)


# ------------------------------------------------- K5: separate q, k, v


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, n, heads, d] -> [B, heads, n, d] (a view)."""
    return x.permute(0, 2, 1, 3)


def mhsa_fused_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, return_stats: bool = False):
    """Plain PyTorch forward of K5 with the kernel's rounding points; with
    `return_stats` also the row statistics [B, heads, n, 2]."""
    dt = q.dtype
    q, k, v = _heads_first(q), _heads_first(k), _heads_first(v)
    qs = (q.float() * scale).to(dt)
    o, stats = _attend(qs, k, v, torch.float32, dt)
    out = o.permute(0, 2, 1, 3).contiguous()
    return (out, stats) if return_stats else out


def mhsa_fused_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  dout: torch.Tensor, scale: float,
                                  stats: torch.Tensor | None = None):
    """Plain PyTorch backward of K5 (the kernel's formula, not autograd):
    dq, dk, dv as [B, n, heads, d]; `stats` are the forward's row
    statistics, if it kept them."""
    dt = q.dtype
    q, k, v = _heads_first(q), _heads_first(k), _heads_first(v)
    qs = (q.float() * scale).to(dt)
    grads = _attend_backward(qs, k, v, _heads_first(dout).float(), torch.float32, dt,
                             scale, stats)
    return tuple(g.to(dt).permute(0, 2, 1, 3).contiguous() for g in grads)


def _check_split(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.ndim != 4 or t.shape != like.shape or t.dtype != like.dtype or \
            t.device != like.device:
        raise ValueError(f"mhsa_fused: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                         f"does not match q {tuple(like.shape)} {like.dtype} on "
                         f"{like.device}")
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"mhsa_fused: the last axis of {name} must be contiguous "
                         f"(strides {t.stride()}); the kernel reads q, k and v in "
                         "place and copies nothing")


def _check_split_cuda(q, *others) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"mhsa_fused: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if q.ndim != 4:
        raise ValueError(f"mhsa_fused: q must be [B, n, heads, d], got {tuple(q.shape)}")
    for name, t in others:
        _check_split(name, t, q)
    _check_split("q", q, q)
    B, n, _, d = q.shape
    if not (1 <= n <= MAX_TOKENS) or d > MAX_HEAD_DIM or B > 65535:
        raise ValueError(
            f"mhsa_fused: shape B={B}, n={n}, head_dim={d} outside the kernel's "
            f"limits (n <= {MAX_TOKENS}, head_dim <= {MAX_HEAD_DIM}, B <= 65535)")


def _strides(t: torch.Tensor):
    """(image, row, head) strides of a [B, n, heads, d] tensor, in elements."""
    return t.stride(0), t.stride(1), t.stride(2)


def _launch_fused_fwd(q, k, v, scale, want_stats: bool = False):
    """K5's forward kernel: out, or (out, stats) with `want_stats`."""
    from autoprog_tpu_torch import _build
    _check_split_cuda(q, ("k", k), ("v", v))
    B, n, H, d = q.shape
    out = torch.empty(B, n, H, d, dtype=q.dtype, device=q.device)
    stats = torch.empty(B, H, n, 2, dtype=torch.float32,
                        device=q.device) if want_stats else None
    with torch.cuda.device(q.device):
        rc = _build.load().mhsa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), B, n, H, d, float(scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_fwd")
    LAUNCHES["fused_fwd"] += 1
    return (out, stats) if want_stats else out


def _launch_fused_bwd(q, k, v, dout, scale, stats=None):
    """K5's backward kernels; `stats` as the forward returned them, or None."""
    from autoprog_tpu_torch import _build
    _check_split_cuda(q, ("k", k), ("v", v), ("dout", dout))
    B, n, H, d = q.shape
    stats_ptr = _check_stats("mhsa_fused backward", stats, q, B, H, n)
    dq, dk, dv = (torch.empty(B, n, H, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    with torch.cuda.device(q.device):
        lib = _build.load()
        scratch = _scratch(lib, q, B, H, n, d)
        rc = lib.mhsa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats_ptr,
            None if scratch is None else scratch.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout), B, n, H, d,
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_bwd")
    LAUNCHES["fused_bwd"] += 1
    return dq, dk, dv


class MhsaFused(torch.autograd.Function):
    """K5 with its hand-written backward (the Pallas op's custom_vjp). The
    forward keeps the row statistics for the backward when one will follow."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        want = any(ctx.needs_input_grad[:3])
        if _on(q) == "cpu":
            res = mhsa_fused_reference(q, k, v, scale, want)
        else:
            res = _launch_fused_fwd(q, k, v, scale, want)
        out, stats = res if want else (res, None)
        ctx.save_for_backward(q, k, v, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, stats = ctx.saved_tensors
        if _on(q) == "cpu":
            dq, dk, dv = mhsa_fused_backward_reference(q, k, v, dout, ctx.scale, stats)
        else:
            if dout.stride(3) != 1:
                # autograd may hand over any layout; the kernel needs lanes
                # contiguous (a gradient, not one of the timed operands)
                dout = dout.contiguous()
            dq, dk, dv = _launch_fused_bwd(q, k, v, dout, ctx.scale, stats)
        return dq, dk, dv, None


def mhsa_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Fused MHSA softmax(q k^T * scale) v per (image, head): q, k, v
    [B, n, heads, d] -> [B, n, heads, d] (see module docstring)."""
    return MhsaFused.apply(q, k, v, scale)
