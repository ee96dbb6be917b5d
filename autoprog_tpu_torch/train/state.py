"""Training state, counterpart of `autoprog_tpu/train/state.py`.

The JAX package keeps one immutable pytree; here the same pieces are
mutable objects updated in place by the train step (saving a copy of every
parameter-sized tree per step): the step count, the model (f32 parameters
and the stem's BatchNorm running stats as buffers), the optimizer with its
moments, and one EMA `state_dict` of the parameters per decay (f32, or
bf16 under `--model-ema-bf16`: `ema_dtype`, kept by stage rebuilds).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Tuple[Dict[str, torch.Tensor], ...]

    @classmethod
    def create(cls, *, model, optimizer, ema_decays=(), ema_dtype=None) -> "TrainState":
        # EMA trees start as copies (not aliases) of the parameters, cast to
        # ema_dtype where one is given (round to nearest: only the per-step
        # increments need stochastic rounding)
        ema = tuple({n: p.detach().to(ema_dtype or p.dtype, copy=True)
                     for n, p in model.named_parameters()}
                    for _ in ema_decays)
        return cls(step=0, model=model, optimizer=optimizer, ema_params=ema)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())
