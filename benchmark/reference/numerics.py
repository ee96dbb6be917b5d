"""Where the reference rounds: every product (linear layer, convolution,
attention product) takes its operands through `Numerics.q`.

  * "float32": `q` is the identity and TF32 is off while the reference
    runs (`float32_exact`), so every product is a float32 product.
  * "fp8": the control. Each operand of a product is rounded to float8
    e4m3 with a per-tensor scale (its absolute maximum onto e4m3's 448),
    and the gradient that flows back into it to float8 e5m2 (scale onto
    57344), as fp8 training recipes do. Everything else stays float32. This
    is the precision below the bf16 the configurations state, the step a
    later change could be tempted to take.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {precision!r}")
        self.precision = precision

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.precision == "float32" else _Fp8.apply(x)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
