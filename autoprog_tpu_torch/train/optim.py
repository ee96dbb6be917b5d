"""Optimizer, gradient clipping and LR schedules, counterpart of
`autoprog_tpu/train/optim.py`.

Every optimizer has two parameter groups: weight decay on parameters with
ndim > 1 other than pos_embed / cls_token / dist_token, none on the rest.

  * adamw / adam: `torch.optim.AdamW`. That is the JAX package's optax chain
    `scale_by_adam -> add_decayed_weights(mask) -> x(-lr)`: both compute
    p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) from the pre-update p
    (`tests/test_torch_train_step.py` checks it step for step).
  * adamw / adam with `--adam-mu-bf16`: `AdamWBf16Mu`, the same update with
    the first moment stored in bf16, as optax's `mu_dtype=bfloat16`
    (`torch.optim.AdamW` keeps its moments in the parameters' dtype).
  * sgd / momentum: `NesterovSGD`, optax `trace(momentum, nesterov=True) ->
    add_decayed_weights(mask) -> x(-lr)`. The decay is added after the
    momentum, from the pre-update p; `torch.optim.SGD(weight_decay=...)`
    would fold it into the momentum buffer, which is another optimizer.

The two hand-written optimizers update all parameters of a group with
`torch._foreach_*` calls and keep the state names of torch's (`step`,
`exp_avg`, `exp_avg_sq`; `momentum_buffer`), so checkpoints hold them alike.

Gradient clipping (`--clip-grad` with `--clip-mode` norm | value | agc)
follows optax's `clip_by_global_norm`, `clip` and `adaptive_grad_clip`; the
AGC unit norms account for the port's [out, in] / OIHW layouts. Under
tensor parallelism (`parallel/tp.py`) they clip the logical gradient: `norm`
takes the global norm with the sums of squares of the sharded leaves summed
over the model group (the replicated leaves, equal on every rank, counted
once); `agc` sums a unit's squares over the model group where the unit spans
the shards (a row-parallel kernel's input axis, a column-parallel bias);
`value` is elementwise.

The schedules are a copy of the JAX module's host code: `train/optim.py`
there imports optax, so it cannot be imported jax-free.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, NamedTuple, Tuple

import numpy as np
import torch

from autoprog_tpu_torch.parallel import tp

NO_WD_NAMES = ("pos_embed", "cls_token", "dist_token")


def decays(name: str, p: torch.Tensor) -> bool:
    """True where weight decay applies: ndim > 1 and not a no-decay name."""
    return p.ndim > 1 and not any(n in NO_WD_NAMES for n in name.split("."))


class AdamWBf16Mu(torch.optim.Optimizer):
    """AdamW with `exp_avg` stored in bf16, step for step optax's
    `scale_by_adam(mu_dtype=bfloat16)`: m32 = (1 - b1) * g + bf16(b1 * m)
    in f32 (optax multiplies the stored bf16 moment by b1 in bf16); this
    step's update uses m32; only then is m stored as bf16(m32), rounded to
    nearest."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        # load_state_dict casts every state tensor to its parameter's dtype
        self.register_load_state_dict_post_hook(AdamWBf16Mu._mu_to_bf16)

    @staticmethod
    def _mu_to_bf16(optimizer) -> None:
        for st in optimizer.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            torch._foreach_add_([self.state[p]["step"] for p in ps], 1.0)
            b1, b2 = group["betas"]
            t = int(self.state[ps[0]]["step"])      # a CPU tensor: no device sync
            grads = [p.grad for p in ps]
            mu = [self.state[p]["exp_avg"] for p in ps]
            nu = [self.state[p]["exp_avg_sq"] for p in ps]
            m32 = torch._foreach_mul(grads, 1.0 - b1)
            # optax rounds b1 to bf16 too; a host scalar, so no copy to the device
            decayed = torch._foreach_mul(mu, float(torch.tensor(b1, dtype=torch.bfloat16)))
            widened = [torch.empty_like(g) for g in grads]
            torch._foreach_copy_(widened, decayed)
            torch._foreach_add_(m32, widened)
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2)
            # bias corrections in f32, as optax computes them
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(m32, bc1)
            torch._foreach_div_(upd, denom)
            if group["weight_decay"]:
                torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
            torch._foreach_add_(ps, upd, alpha=-group["lr"])
            torch._foreach_copy_(mu, m32)


class NesterovSGD(torch.optim.Optimizer):
    """optax `trace(decay=momentum, nesterov=True)` then
    `add_decayed_weights` then x(-lr): buf = g + m * buf, u = g + m * buf +
    wd * p, p -= lr * u (p the pre-update parameter)."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                self.state[p].setdefault("momentum_buffer", torch.zeros_like(p))
            m = group["momentum"]
            grads = [p.grad for p in ps]
            bufs = [self.state[p]["momentum_buffer"] for p in ps]
            torch._foreach_mul_(bufs, m)
            torch._foreach_add_(bufs, grads)
            upd = torch._foreach_mul(bufs, m)
            torch._foreach_add_(upd, grads)
            if group["weight_decay"]:
                torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
            torch._foreach_add_(ps, upd, alpha=-group["lr"])


def create_optimizer(args, model: torch.nn.Module) -> torch.optim.Optimizer:
    opt = args.opt.lower()
    if opt not in ("adamw", "adam", "sgd", "momentum"):
        raise ValueError(f"unsupported optimizer {args.opt!r}")
    wd = args.weight_decay if opt != "adam" else 0.0
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if decays(n, p)], "weight_decay": wd},
        {"params": [p for n, p in named if not decays(n, p)], "weight_decay": 0.0},
    ]
    # lr is set from the schedule before every step
    if opt in ("sgd", "momentum"):
        return NesterovSGD(groups, momentum=args.momentum)
    betas = tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999)
    eps = args.opt_eps if args.opt_eps is not None else 1e-8
    if getattr(args, "adam_mu_bf16", False):
        return AdamWBf16Mu(groups, betas=betas, eps=eps)
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
        """By the global norm of the logical gradient: the sums of squares
        of the sharded leaves summed over the model group, the replicated
        leaves' counted once."""
        sq = [torch.linalg.vector_norm(p.grad.float()).square() for _, p in named]
        sharded = [tp.param_spec(n, p.ndim) is not None for n, p in named]
        zero = sq[0].new_zeros(())
        norm = (tp.model_sum(sum((s for s, sh in zip(sq, sharded) if sh), zero))
                + sum((s for s, sh in zip(sq, sharded) if not sh), zero)).sqrt()
        for _, p in named:
            p.grad.copy_(torch.where(norm < c, p.grad, p.grad / norm * c))

    def clip_value(named):
        for _, p in named:
            p.grad.clamp_(-c, c)

    def unit_norms(name, p, dims):
        """The unit norms of the gradient and of the parameter; summed over
        the model group where the unit spans the shards."""
        spec = tp.param_spec(name, p.ndim)
        if spec is None or spec[0] not in dims:
            return (torch.linalg.vector_norm(p.grad, dim=dims, keepdim=True),
                    torch.linalg.vector_norm(p.detach(), dim=dims, keepdim=True))
        sq = torch.stack([p.grad.square().sum(dims, keepdim=True),
                          p.detach().square().sum(dims, keepdim=True)])
        g_norm, p_norm = tp.model_sum(sq).to(p.dtype).sqrt().unbind(0)
        return g_norm, p_norm

    def clip_agc(named, eps=1e-3, div_eps=1e-6):
        for name, p in named:
            dims = _unit_dims(name, p)
            g_norm, p_norm = unit_norms(name, p, dims)
            max_norm = c * p_norm.clamp_min(eps)
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

    def load_state_dict(self, d: dict) -> None:
        self._lr, self._best, self._bad_epochs = d["lr"], d["best"], d["bad_epochs"]
