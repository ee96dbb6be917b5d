"""Training state, counterpart of `autoprog_tpu/train/state.py`.

The JAX package keeps one immutable pytree; here the same pieces are
mutable objects updated in place by the train step (saving a copy of every
parameter-sized tree per step): the step count, the model (f32 parameters
and the stem's BatchNorm running stats as buffers), the optimizer with its
moments, and one EMA `state_dict` of the parameters per decay.
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
    def create(cls, *, model, optimizer, ema_decays=()) -> "TrainState":
        # EMA trees start as copies (not aliases) of the parameters
        ema = tuple({n: p.detach().clone() for n, p in model.named_parameters()}
                    for _ in ema_decays)
        return cls(step=0, model=model, optimizer=optimizer, ema_params=ema)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())
