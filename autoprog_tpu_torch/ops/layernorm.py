"""LayerNorm over the last axis: a CUDA kernel pair and its plain twin.

Flax's `nn.LayerNorm(dtype)` as the models use it: f32 statistics (mean and
biased variance), eps 1e-6, f32 gamma and beta, the output rounded once to
the working dtype. The kernels are `csrc/layernorm.cu`: one forward kernel
that reads each row once and writes y, and a backward of two kernels (dx
with per-strip partial sums of dgamma and dbeta, then a fixed-order sum of
the partials). No TPU kernel stands behind them: the JAX package leaves
LayerNorm to XLA. They exist because the plain path's widen, norm and cast
chain moved about five times the bytes one pass needs (the source note has
the numbers).

`layer_norm(x, weight, bias, eps, dtype)`: on a CUDA tensor `LayerNormFn`
launches the kernels or raises (no fallback): x in bf16 or f32 equal to
`dtype`, its last axis C a multiple of 8 from 8 to 1024, weight and bias f32
of C values. The layout of a row follows C alone. On any other device it
runs the twin, `layer_norm_reference`, which is the models' code before the
kernels: `F.layer_norm(x.float(), ...).to(dtype)`.

Rounding points, shared by the kernels and the twin: x widens exactly,
statistics and affine run in f32, y is rounded once; in the backward dx is
rounded once to x's dtype and dgamma, dbeta stay f32. Only the order of the
f32 sums differs. The kernels use no atomics, so a result has the same bits
from run to run.

The Function saves x in its own dtype and the per-row mean and rstd (f32).
`LAUNCHES` counts kernel launches: one a forward, two a backward; the twin
does not count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from autoprog_tpu_torch import _build

#: kernel launches made by LayerNormFn (the twin is not counted)
LAUNCHES = {"fwd": 0, "bwd": 0}

#: the widest row the kernels take
MAX_C = 1024
#: the most strips (blocks) the backward's first kernel splits the rows
#: into, each writing one [2, C] row of partial sums: two blocks of 256
#: threads on each of the H100's 132 SMs, one wave
BWD_STRIPS = 264

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The plain twin: widen, F.layer_norm in f32, round to `dtype`."""
    return F.layer_norm(x.float(), weight.shape, weight, bias, eps).to(dtype)


def check_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> None:
    """Raise where the kernels do not take the call."""
    C = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or x.dtype != dtype:
        raise ValueError(f"layer_norm: input {x.dtype} with output {dtype}; the kernels take "
                         "float32 or bfloat16 in and out alike")
    if C % 8 or not 8 <= C <= MAX_C:
        raise ValueError(f"layer_norm: the kernels take a last axis that is a multiple of 8 "
                         f"from 8 to {MAX_C}, got {C}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (C,) or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be contiguous float32 of shape ({C},) "
                             f"on {x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")


def _call(name: str, t: torch.Tensor, *args) -> None:
    """Entry point `name` of the kernel library on t's device and its current
    stream (the device is the current one in a process a card and on
    autograd's backward thread; elsewhere it is made current for the call)."""
    fn = getattr(_build.load(), name)
    dev = t.get_device()
    if dev == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, name)


def _launch_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    C = x.shape[-1]
    rows = x.numel() // C
    y = torch.empty_like(x)
    stats = torch.empty(2, rows, dtype=torch.float32, device=x.device)
    _call("layernorm_fwd", x, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
          stats.data_ptr(), rows, C, eps, _DTYPE_CODE[x.dtype])
    LAUNCHES["fwd"] += 1
    return y, stats


def _launch_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, stats: torch.Tensor):
    """dy has y's shape and dtype (autograd checks that), so x's."""
    dy = dy.contiguous()
    C = x.shape[-1]
    rows = x.numel() // C
    strips = max(1, min(rows, BWD_STRIPS))
    dx = torch.empty_like(x)
    partial = torch.empty(strips, 2, C, dtype=torch.float32, device=x.device)
    dgamma = torch.empty(C, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(C, dtype=torch.float32, device=x.device)
    _call("layernorm_bwd", x, x.data_ptr(), dy.data_ptr(), weight.data_ptr(), stats.data_ptr(),
          dx.data_ptr(), partial.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), rows, C,
          strips, _DTYPE_CODE[x.dtype])
    LAUNCHES["bwd"] += 2
    return dx, dgamma, dbeta


class LayerNormFn(torch.autograd.Function):
    """The kernel pair with its hand-written backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        x = x.contiguous()
        y, stats = _launch_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, dgamma, dbeta = _launch_bwd(x, dy, weight, stats)
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis with the output in `dtype` (see the
    module docstring): the kernels on a CUDA tensor, the twin elsewhere."""
    if x.is_cuda:
        check_cuda(x, weight, bias, dtype)
        return LayerNormFn.apply(x, weight, bias, eps)
    return layer_norm_reference(x, weight, bias, eps, dtype)
