"""Optimizer, gradient clipping and LR schedules, counterpart of
`autoprog_tpu/train/optim.py`.

AdamW is `torch.optim.AdamW` with two parameter groups: weight decay on
parameters with ndim > 1 other than pos_embed / cls_token / dist_token, none
on the rest. That is the JAX package's optax chain `scale_by_adam ->
add_decayed_weights(mask) -> x(-lr)`: both compute p - lr * (m_hat /
(sqrt(v_hat) + eps) + wd * p) from the pre-update p
(`tests/test_torch_train_step.py` checks it step for step).

Gradient clipping (`--clip-grad` with `--clip-mode` norm | value | agc)
follows optax's `clip_by_global_norm`, `clip` and `adaptive_grad_clip`; the
AGC unit norms account for the port's [out, in] / OIHW layouts.

The schedules are a copy of the JAX module's host code: `train/optim.py`
there imports optax, so it cannot be imported jax-free.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, NamedTuple, Tuple

import torch

NO_WD_NAMES = ("pos_embed", "cls_token", "dist_token")


def decays(name: str, p: torch.Tensor) -> bool:
    """True where weight decay applies: ndim > 1 and not a no-decay name."""
    return p.ndim > 1 and not any(n in NO_WD_NAMES for n in name.split("."))


def create_optimizer(args, model: torch.nn.Module) -> torch.optim.Optimizer:
    opt = args.opt.lower()
    if opt not in ("adamw", "adam"):
        raise NotImplementedError(f"--opt {args.opt}: only adamw and adam are "
                                  "ported yet")
    betas = tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999)
    eps = args.opt_eps if args.opt_eps is not None else 1e-8
    wd = args.weight_decay if opt == "adamw" else 0.0
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if decays(n, p)], "weight_decay": wd},
        {"params": [p for n, p in named if not decays(n, p)], "weight_decay": 0.0},
    ]
    # lr is set from the schedule before every step
    return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=eps)


def _unit_dims(name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """Axes summed for optax's unitwise_norm, in the port's layouts."""
    if p.squeeze().ndim <= 1:
        return tuple(range(p.ndim))
    if name.endswith("weight") and p.ndim in (2, 4):   # [out, in] / OIHW
        return tuple(range(1, p.ndim))
    if p.ndim == 4:                                     # pos_embed [1, g, g, C]
        return (0, 1, 2)
    return (0,)


def create_grad_clip(args) -> Callable[[Iterable], None] | None:
    """In-place gradient clipping on (name, param) pairs, or None."""
    if args.clip_grad is None:
        return None
    c, mode = args.clip_grad, args.clip_mode

    def clip_norm(named):
        grads = [p.grad for _, p in named]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        for g in grads:
            g.copy_(torch.where(norm < c, g, g / norm * c))

    def clip_value(named):
        for _, p in named:
            p.grad.clamp_(-c, c)

    def clip_agc(named, eps=1e-3, div_eps=1e-6):
        for name, p in named:
            dims = _unit_dims(name, p)
            g_norm = torch.linalg.vector_norm(p.grad, dim=dims, keepdim=True)
            max_norm = c * torch.linalg.vector_norm(p.detach(), dim=dims,
                                                    keepdim=True).clamp_min(eps)
            clipped = p.grad * (max_norm / g_norm.clamp_min(div_eps))
            p.grad.copy_(torch.where(g_norm < max_norm, p.grad, clipped))

    modes = {"norm": clip_norm, "value": clip_value, "agc": clip_agc}
    if mode not in modes:
        raise ValueError(f"unknown clip mode {mode}")
    return modes[mode]


# ---------------------------------------------------------------------------
# LR schedules (host scalars, evaluated per epoch)


class Schedule(NamedTuple):
    fn: Callable[[float], float]   # epoch (float) -> lr
    num_epochs: int                # total epochs to run (incl. cooldown)


def _noise_wrap(schedule: Schedule, args, t_initial: int) -> Schedule:
    """timm-0.4.5 `--lr-noise`: from epoch lr_noise[0]*epochs (until
    lr_noise[1]*epochs), lr * (1 + noise), noise ~ N(0, 1) redrawn until
    |noise| < lr_noise_pct, from torch's generator seeded seed + epoch."""
    lr_noise = getattr(args, "lr_noise", None)
    if not lr_noise:
        return schedule
    rng_range = [n * t_initial for n in lr_noise]
    lo = rng_range[0]
    hi = rng_range[1] if len(rng_range) > 1 else None
    noise_pct = getattr(args, "lr_noise_pct", 0.67)
    seed = getattr(args, "seed", None)
    noise_seed = 42 if seed is None else seed
    base_fn = schedule.fn

    def fn(epoch: float) -> float:
        lr = base_fn(epoch)
        t = int(epoch)
        apply = (lo <= t < hi) if hi is not None else t >= lo
        if apply:
            g = torch.Generator()
            g.manual_seed(noise_seed + t)
            while True:
                noise = torch.randn(1, generator=g).item()
                if abs(noise) < noise_pct:
                    break
            lr = lr + lr * noise
        return lr

    return Schedule(fn, schedule.num_epochs)


def _warmup(warmup_lr, base_lr, warmup_t, epoch):
    return warmup_lr + (base_lr - warmup_lr) * epoch / max(warmup_t, 1)


def create_scheduler(args):
    sched = args.sched
    base_lr, min_lr, warmup_lr = args.lr, args.min_lr, args.warmup_lr
    warmup_t = args.warmup_epochs
    t_initial = args.epochs

    if sched == "cosine":
        # timm 0.4.5 CosineLRScheduler with SGDR restarts (t_mul, cycle
        # limit, decay_rate per cycle); warmup_prefix=False
        t_mul = float(getattr(args, "lr_cycle_mul", 1.0) or 1.0)
        cycle_limit = int(getattr(args, "lr_cycle_limit", 1))
        decay_rate = float(getattr(args, "decay_rate", 0.1))

        def fn(epoch: float) -> float:
            if epoch < warmup_t:
                return _warmup(warmup_lr, base_lr, warmup_t, epoch)
            t = epoch
            if t_mul != 1.0:
                log_arg = 1 - t / t_initial * (1 - t_mul)
                if log_arg <= 0:
                    return min_lr
                i = int(math.floor(math.log(log_arg, t_mul)))
                t_i = t_mul ** i * t_initial
                t_curr = t - (1 - t_mul ** i) / (1 - t_mul) * t_initial
            else:
                i = int(t // t_initial)
                t_i = t_initial
                t_curr = t - t_initial * i
            gamma = decay_rate ** i
            if cycle_limit == 0 or i < cycle_limit:
                lr_min_i = min_lr * gamma
                lr_max_i = base_lr * gamma
                return lr_min_i + 0.5 * (lr_max_i - lr_min_i) * (
                    1 + math.cos(math.pi * t_curr / max(t_i, 1e-9)))
            return min_lr

        cycles = max(1, cycle_limit)
        if t_mul == 1.0:
            total = t_initial * cycles
        else:
            total = int(math.floor(-t_initial * (t_mul ** cycles - 1) / (1 - t_mul)))
        return _noise_wrap(Schedule(fn, total + args.cooldown_epochs), args, t_initial)

    if sched == "step":
        def fn(epoch: float) -> float:
            if epoch < warmup_t:
                return _warmup(warmup_lr, base_lr, warmup_t, epoch)
            return base_lr * (args.decay_rate ** (int(epoch) // int(args.decay_epochs)))
        return _noise_wrap(Schedule(fn, t_initial + args.cooldown_epochs), args, t_initial)

    if sched == "tanh":
        def fn(epoch: float) -> float:
            if epoch < warmup_t:
                return _warmup(warmup_lr, base_lr, warmup_t, epoch)
            if epoch >= t_initial:
                return min_lr
            t = (epoch - warmup_t) / max(t_initial - warmup_t, 1)
            lb, ub = -7.0, 3.0
            return min_lr + 0.5 * (base_lr - min_lr) * (1 - math.tanh(lb + t * (ub - lb)))
        return _noise_wrap(Schedule(fn, t_initial + args.cooldown_epochs), args, t_initial)

    if sched == "plateau":
        return PlateauSchedule(
            base_lr=base_lr, min_lr=min_lr, warmup_lr=warmup_lr, warmup_t=warmup_t,
            num_epochs=t_initial + args.cooldown_epochs, decay_rate=args.decay_rate,
            patience=args.patience_epochs,
            mode="min" if args.eval_metric == "loss" else "max")

    if sched in ("none", "constant"):
        return Schedule(lambda e: base_lr, t_initial)

    raise ValueError(f"unsupported scheduler {sched!r}")


class PlateauSchedule:
    """Metric-driven LR decay (timm `--sched plateau`): `fn(epoch)` and
    `num_epochs` like `Schedule`, plus `observe(metric)` once per epoch."""

    def __init__(self, base_lr, min_lr, warmup_lr, warmup_t, num_epochs,
                 decay_rate=0.1, patience=10, mode="max"):
        self.base_lr, self.min_lr, self.warmup_lr = base_lr, min_lr, warmup_lr
        self.warmup_t, self.num_epochs = warmup_t, num_epochs
        self.decay_rate, self.patience, self.mode = decay_rate, patience, mode
        self._lr = base_lr
        self._best = None
        self._bad_epochs = 0

    def fn(self, epoch: float) -> float:
        if epoch < self.warmup_t:
            return _warmup(self.warmup_lr, self.base_lr, self.warmup_t, epoch)
        return self._lr

    def observe(self, metric: float) -> None:
        better = (self._best is None
                  or (self.mode == "max" and metric > self._best)
                  or (self.mode == "min" and metric < self._best))
        if better:
            self._best = metric
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._lr = max(self._lr * self.decay_rate, self.min_lr)
                self._bad_epochs = 0

    def state_dict(self) -> dict:
        return {"lr": self._lr, "best": self._best, "bad_epochs": self._bad_epochs}
