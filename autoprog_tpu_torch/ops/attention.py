"""Fused MHSA: on the raw qkv projection (K1) and on separate q, k, v (K5);
CUDA kernels and plain twins.

Counterpart of `autoprog_tpu/ops/attention_pallas.py` (`mhsa_fused_qkv`,
`mhsa_fused`). The kernels are `csrc/mhsa_qkv.cu` (forward, and a two-pass
backward that recomputes the probabilities); their source note says what
bounds them and how the design answers it.

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

`mhsa_fused(q, k, v, scale)` is the same function on separate q, k, v of
shape [B, n, heads, d] with the scores always f32, returning
[B, n, heads, d]. The kernel reads each operand in place by its strides (a
contiguous tensor or, say, one of the three views of a [B, n, 3, heads, d]
buffer); only the last axis must be contiguous, and nothing is copied or
transposed on the way in. Its gradients are three contiguous tensors.

`LAUNCHES` counts kernel launches by the wrappers ("fwd", "bwd" for K1,
"fused_fwd", "fused_bwd" for K5); the twins do not count.
"""

from __future__ import annotations

import os

import torch

#: kernel launches made by MhsaFusedQkv and MhsaFused (plain twins are not
#: counted)
LAUNCHES = {"fwd": 0, "bwd": 0, "fused_fwd": 0, "fused_bwd": 0}

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


def _probs(qs, k, sdt):
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)).to(sdt).float()
    return s - s.amax(-1, keepdim=True)


def mhsa_fused_qkv_reference(qkv: torch.Tensor, num_heads: int, scale: float,
                             scores_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch forward of K1 with the kernel's rounding points."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    qs = (q.float() * scale).to(dt)
    e = torch.exp(_probs(qs, k, torch.float32 if scores_f32 else dt))
    z = e.sum(-1, keepdim=True)
    o = torch.matmul(e.to(dt).float(), v.float()) / z
    return _merge_heads(o.to(dt))


def mhsa_fused_qkv_backward_reference(qkv: torch.Tensor, dout: torch.Tensor,
                                      num_heads: int, scale: float,
                                      scores_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch backward of K1 (the kernel's formula, not autograd)."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    B, n, C = dout.shape
    do = dout.view(B, n, num_heads, C // num_heads).permute(0, 2, 1, 3).float()
    qs = (q.float() * scale).to(dt)
    e = torch.exp(_probs(qs, k, torch.float32 if scores_f32 else dt))
    p = e / e.sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    grads = torch.stack([dq, dk, dv])                     # [3, B, h, n, d]
    return grads.permute(1, 3, 0, 2, 4).reshape(B, n, 3 * C).to(dt)


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


def _launch_fwd(qkv, num_heads, scale, scores_f32):
    from autoprog_tpu_torch import _build
    _check_cuda(qkv, num_heads)
    B, n, C3 = qkv.shape
    out = torch.empty(B, n, C3 // 3, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _build.load().mhsa_qkv_fwd(
            qkv.data_ptr(), out.data_ptr(), B, n, C3 // 3, num_heads,
            float(scale), int(scores_f32), _DTYPE_CODE[qkv.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_qkv_fwd")
    LAUNCHES["fwd"] += 1
    return out


def _launch_bwd(qkv, dout, num_heads, scale, scores_f32):
    from autoprog_tpu_torch import _build
    _check_cuda(qkv, num_heads)
    B, n, C3 = qkv.shape
    dout = dout.contiguous()
    if (dout.dtype != qkv.dtype or dout.device != qkv.device
            or tuple(dout.shape) != (B, n, C3 // 3)):
        raise ValueError(f"mhsa_fused_qkv backward: dout {tuple(dout.shape)} "
                         f"{dout.dtype} on {dout.device} does not match qkv "
                         f"{tuple(qkv.shape)} {qkv.dtype} on {qkv.device}")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(B * num_heads * n * 3, dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _build.load().mhsa_qkv_bwd(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, n, C3 // 3, num_heads, float(scale), int(scores_f32),
            _DTYPE_CODE[qkv.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_qkv_bwd")
    LAUNCHES["bwd"] += 1
    return dqkv


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused MHSA: unsupported device {t.device}")
    return t.device.type


class MhsaFusedQkv(torch.autograd.Function):
    """K1 with its hand-written backward (the Pallas op's custom_vjp)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, scores_f32: bool):
        ctx.save_for_backward(qkv)
        ctx.cfg = (num_heads, scale, scores_f32)
        if _on(qkv) == "cpu":
            return mhsa_fused_qkv_reference(qkv, num_heads, scale, scores_f32)
        return _launch_fwd(qkv, num_heads, scale, scores_f32)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        num_heads, scale, scores_f32 = ctx.cfg
        if _on(qkv) == "cpu":
            dqkv = mhsa_fused_qkv_backward_reference(qkv, dout, num_heads,
                                                     scale, scores_f32)
        else:
            dqkv = _launch_bwd(qkv, dout, num_heads, scale, scores_f32)
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
                         scale: float) -> torch.Tensor:
    """Plain PyTorch forward of K5 with the kernel's rounding points."""
    dt = q.dtype
    q, k, v = _heads_first(q), _heads_first(k), _heads_first(v)
    qs = (q.float() * scale).to(dt)
    e = torch.exp(_probs(qs, k, torch.float32))
    z = e.sum(-1, keepdim=True)
    o = torch.matmul(e.to(dt).float(), v.float()) / z
    return o.to(dt).permute(0, 2, 1, 3).contiguous()


def mhsa_fused_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  dout: torch.Tensor, scale: float):
    """Plain PyTorch backward of K5 (the kernel's formula, not autograd):
    dq, dk, dv as [B, n, heads, d]."""
    dt = q.dtype
    q, k, v = _heads_first(q), _heads_first(k), _heads_first(v)
    do = _heads_first(dout).float()
    qs = (q.float() * scale).to(dt)
    e = torch.exp(_probs(qs, k, torch.float32))
    p = e / e.sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    return tuple(g.to(dt).permute(0, 2, 1, 3).contiguous() for g in (dq, dk, dv))


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


def _launch_fused_fwd(q, k, v, scale):
    from autoprog_tpu_torch import _build
    _check_split_cuda(q, ("k", k), ("v", v))
    B, n, H, d = q.shape
    out = torch.empty(B, n, H, d, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.load().mhsa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), B, n, H, d, float(scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_fwd")
    LAUNCHES["fused_fwd"] += 1
    return out


def _launch_fused_bwd(q, k, v, dout, scale):
    from autoprog_tpu_torch import _build
    _check_split_cuda(q, ("k", k), ("v", v), ("dout", dout))
    B, n, H, d = q.shape
    dq, dk, dv = (torch.empty(B, n, H, d, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    stats = torch.empty(B * H * n * 3, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _build.load().mhsa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout), B, n, H, d,
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mhsa_bwd")
    LAUNCHES["fused_bwd"] += 1
    return dq, dk, dv


class MhsaFused(torch.autograd.Function):
    """K5 with its hand-written backward (the Pallas op's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if _on(q) == "cpu":
            return mhsa_fused_reference(q, k, v, scale)
        return _launch_fused_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if _on(q) == "cpu":
            dq, dk, dv = mhsa_fused_backward_reference(q, k, v, dout, ctx.scale)
        else:
            if dout.stride(3) != 1:
                # autograd may hand over any layout; the kernel needs lanes
                # contiguous (a gradient, not one of the timed operands)
                dout = dout.contiguous()
            dq, dk, dv = _launch_fused_bwd(q, k, v, dout, ctx.scale)
        return dq, dk, dv, None


def mhsa_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Fused MHSA softmax(q k^T * scale) v per (image, head): q, k, v
    [B, n, heads, d] -> [B, n, heads, d] (see module docstring)."""
    return MhsaFused.apply(q, k, v, scale)
