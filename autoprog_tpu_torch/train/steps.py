"""Train and eval steps, counterpart of `autoprog_tpu/train/steps.py`.

One train step, in the JAX step's order: build the target (token-label
maps on the device) -> resize the batch to the stage resolution -> VOLO
forward -> loss -> backward -> gradient clip -> AdamW -> one EMA sweep per
decay (`torch._foreach_*` over all parameters). Gradient accumulation
(`splits` > 1) is a Python loop over micro-batches with one optimizer
update. PyTorch runs eagerly, so there is no per-configuration program
cache: (r, keep, splits) are arguments of the call.

Randomness: DropPath/dropout draw from `drop_gen` (on the device) and the
MixToken box from `mix_gen` (on the host), both seeded from the run seed.

The search probes (`loss_probe_step`, `throughput_probe_step`,
`chained_throughput_probe`) run the model in train mode without changing
the training state: BatchNorm running stats are put back afterwards,
gradients are discarded, no optimizer step is taken, and the caller passes
the generators, so that every candidate sees the same draws.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from autoprog_tpu_torch.data.token_label import build_token_label_target, smooth_one_hot
from autoprog_tpu_torch.ops.interpolate import resize_bilinear
from autoprog_tpu_torch.train.state import TrainState


def _ce_per_sample(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def metrics_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """loss/top1/top5 sums over a batch; label < 0 marks padding rows
    (`pad_eval_batch`) and masks out of every sum."""
    valid = labels >= 0
    loss = _ce_per_sample(logits, labels.clamp_min(0))
    top1 = (logits.argmax(-1) == labels) & valid
    k5 = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
    top5 = (k5 == labels[:, None]).any(-1) & valid
    return {"loss_sum": torch.where(valid, loss, torch.zeros_like(loss)).sum(),
            "top1_sum": top1.sum().float(), "top5_sum": top5.sum().float(),
            "count": valid.sum().float()}


@contextlib.contextmanager
def _buffers_restored(model: torch.nn.Module):
    """Put the model's buffers (BatchNorm running stats) back on exit: a
    train-mode forward updates them in place."""
    saved = [b.clone() for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, old in zip(model.buffers(), saved):
                b.copy_(old)


class StepBuilder:
    def __init__(self, *, train_loss: Callable, ema_decays: Tuple[float, ...] = (),
                 num_classes: int = 1000, smoothing: float = 0.1,
                 token_label: bool = False, has_token_label_data: bool = False,
                 grad_clip: Optional[Callable] = None,
                 device: torch.device = torch.device("cpu"), seed: int = 0):
        self.train_loss = train_loss
        self.ema_decays = tuple(ema_decays)
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.token_label = token_label
        self.has_token_label_data = has_token_label_data
        self.grad_clip = grad_clip
        self.drop_gen = torch.Generator(device).manual_seed(seed + 1)
        self.mix_gen = torch.Generator("cpu").manual_seed(seed + 2)

    def build_target(self, batch: Dict[str, torch.Tensor], r: int):
        """Device-side target: host-mixed soft targets, token-label maps at
        the token grid r // 16, or smoothed one-hot rows."""
        if "soft_target" in batch:
            return batch["soft_target"]
        if self.token_label and self.has_token_label_data and "label_scores" in batch:
            return build_token_label_target(
                batch["label"], batch["label_scores"], batch["label_inds"],
                num_classes=self.num_classes, smoothing=self.smoothing,
                label_size=r // 16, gt_soft=batch.get("gt_soft"))
        return smooth_one_hot(batch["label"], self.num_classes, self.smoothing)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor], lr: float, *,
                   r: int, keep=None, splits: int = 1,
                   bbox: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimizer update, in place on `state`; returns {"loss"} as a
        device scalar (no host sync). `bbox` injects the MixToken box."""
        model = state.model
        images, target = batch["image"], self.build_target(batch, r)
        mb = images.shape[0] // splits
        loss_sum = torch.zeros((), device=images.device)
        for i in range(splits):
            sl = slice(i * mb, (i + 1) * mb)
            out = model(resize_bilinear(images[sl], r), train=True, keep=keep,
                        bbox=bbox, drop_gen=self.drop_gen, mix_gen=self.mix_gen)
            loss = self.train_loss(out, target[sl])
            (loss / splits).backward()
            loss_sum += loss.detach()
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        if self.grad_clip is not None:
            with torch.no_grad():
                self.grad_clip(named)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        if self.ema_decays:
            params = [p.detach() for p in model.parameters()]
            with torch.no_grad():
                for d, ema in zip(self.ema_decays, state.ema_params):
                    e = list(ema.values())
                    torch._foreach_mul_(e, d)
                    torch._foreach_add_(e, params, alpha=1.0 - d)
        state.step += 1
        return {"loss": loss_sum / splits}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *, keep=None,
                  params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Metric sums of one eval batch; `params` (an EMA tree) replaces the
        model's parameters for this call."""
        model = state.model
        if params is None:
            logits = model(batch["image"], train=False, keep=keep)
        else:
            logits = torch.func.functional_call(model, params, (batch["image"],),
                                                {"train": False, "keep": keep})
        if isinstance(logits, tuple):
            logits = logits[0]
        return metrics_from_logits(logits, batch["label"])

    # ------------------------------------------------------- search probes

    def _probe_forward(self, state, images, r, keep, params, drop_gen, mix_gen):
        kwargs = {"train": True, "keep": keep, "drop_gen": drop_gen or self.drop_gen,
                  "mix_gen": mix_gen or self.mix_gen}
        x = resize_bilinear(images, r)
        if params is None:
            return state.model(x, **kwargs)
        return torch.func.functional_call(state.model, params, (x,), kwargs)

    @torch.no_grad()
    def loss_probe_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *, r: int,
                        keep=None, params: Optional[Dict[str, torch.Tensor]] = None,
                        drop_gen: Optional[torch.Generator] = None,
                        mix_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Train-mode forward, hard-label CE on the cls logits, batch mean:
        the search loss probe. `params` (an EMA tree) replaces the model's
        parameters for this call. A device scalar; no host sync."""
        with _buffers_restored(state.model):
            out = self._probe_forward(state, batch["image"], r, keep, params,
                                      drop_gen, mix_gen)
        logits = out[0] if isinstance(out, tuple) else out
        return _ce_per_sample(logits, batch["label"]).mean()

    def throughput_probe_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *,
                              r: int, keep=None,
                              params: Optional[Dict[str, torch.Tensor]] = None,
                              drop_gen: Optional[torch.Generator] = None,
                              mix_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward + backward of the training loss without an optimizer
        update; the gradients are discarded. Returns the loss (device
        scalar)."""
        if params is not None:
            params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        target = self.build_target(batch, r)
        with _buffers_restored(state.model):
            out = self._probe_forward(state, batch["image"], r, keep, params,
                                      drop_gen, mix_gen)
            loss = self.train_loss(out, target)
            loss.backward()
        state.model.zero_grad(set_to_none=True)
        return loss.detach()

    def chained_throughput_probe(self, state: TrainState, batch: Dict[str, torch.Tensor], *,
                                 r: int, keep=None, iters: int = 10, params=None,
                                 drop_gen=None, mix_gen=None) -> float:
        """Seconds per forward + backward step: one warm-up step, then
        `iters` steps between two CUDA events (on the CPU, between two reads
        of `time.perf_counter`). This is the time that feeds the grow
        criterion."""
        def step():
            return self.throughput_probe_step(state, batch, r=r, keep=keep, params=params,
                                              drop_gen=drop_gen, mix_gen=mix_gen)
        step()
        if batch["image"].device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            return (time.perf_counter() - t0) / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            step()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters * 1e-3
