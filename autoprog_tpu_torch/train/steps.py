"""Train and eval steps, counterpart of `autoprog_tpu/train/steps.py`.

One train step, in the JAX step's order: build the target (the integer
labels for a loss that wants them, else token-label maps or their sparse
form under AUTOPROG_SPARSE_TL=1, on the device) -> normalise a uint8 batch
and random-erase it (`prep_images`) -> resize the batch to the stage
resolution -> VOLO forward -> loss -> backward -> zeros for the gradients
of the layers a keep mask skipped (as `jax.grad` gives them) -> under a
process group, one all-reduce that averages the gradients over the ranks
(`parallel/mesh.py`) -> gradient clip -> the optimizer -> one EMA sweep per
decay (`torch._foreach_*` over all parameters; bf16 trees accumulate in f32
and are stored with stochastic rounding). Gradient accumulation (`splits` > 1) is a Python loop over
micro-batches with one optimizer update. PyTorch runs eagerly, so there is
no per-configuration program cache: (r, keep, splits, re_prob) are
arguments of the call.

Randomness: DropPath/dropout draw from `drop_gen`, the erase boxes from
`erase_gen` and the rounding dither from `ema_gen` (all on the device), the
MixToken box from `mix_gen` (on the host). Under a process group the
per-sample generators (`drop_gen`, `erase_gen`) are seeded from the seed
plus the rank, as the JAX package's step key; `mix_gen` and `ema_gen` from
the seed alone: MixToken pairs rows across the global batch, which takes one
box for all of it, and the EMA trees are replicated state, which takes the
same rounding on every rank.

The search probes (`loss_probe_step`, `throughput_probe_step`,
`chained_throughput_probe`) run the model in train mode without changing
the training state: BatchNorm running stats are put back afterwards,
gradients are discarded, no optimizer step is taken, and the caller passes
the generators, so that every candidate sees the same draws. Under a process
group the loss probe is averaged over the ranks; the timed probe stays per
rank (the grow decision is rank 0's, broadcast).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from autoprog_tpu_torch.data.token_label import (
    build_token_label_target,
    smooth_one_hot,
    sparse_token_label_target,
)
from autoprog_tpu_torch.ops.erase import normalize_uint8, random_erase
from autoprog_tpu_torch.ops.interpolate import resize_bilinear
from autoprog_tpu_torch.ops.rounding import cast_bf16_sr
from autoprog_tpu_torch.parallel import mesh, tp
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.utils import spans

#: gradients the train step filled with zeros (parameters the forward did
#: not reach); a step without a keep mask adds none
GRAD_FILLS = {"params": 0}


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


def _widened(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A parameter tree as the model's f32 parameters: a bf16 EMA tree
    (`--model-ema-bf16`) is widened, as Flax casts it in the JAX package."""
    return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in params.items()}


def _rows(target, sl: slice):
    """Rows `sl` of a target: a tensor, or the sparse token-label dict."""
    if isinstance(target, dict):
        return {k: v[sl] for k, v in target.items()}
    return target[sl]


class StepBuilder:
    def __init__(self, *, train_loss: Callable, ema_decays: Tuple[float, ...] = (),
                 num_classes: int = 1000, smoothing: float = 0.1,
                 token_label: bool = False, has_token_label_data: bool = False,
                 grad_clip: Optional[Callable] = None,
                 device: torch.device = torch.device("cpu"), seed: int = 0,
                 norm_mean=(0.485, 0.456, 0.406), norm_std=(0.229, 0.224, 0.225),
                 re_count: int = 1, rank: int = 0):
        self.train_loss = train_loss
        self.ema_decays = tuple(ema_decays)
        self.num_classes = num_classes
        self.smoothing = smoothing
        self.token_label = token_label
        self.has_token_label_data = has_token_label_data
        self.grad_clip = grad_clip
        self.norm_mean, self.norm_std = tuple(norm_mean), tuple(norm_std)
        self.re_count = re_count
        self.drop_gen = torch.Generator(device).manual_seed(seed + rank + 1)
        # the same draws on every rank: one MixToken box for the global batch,
        # one rounding of the replicated EMA trees
        self.mix_gen = torch.Generator("cpu").manual_seed(seed + 2)
        self.erase_gen = torch.Generator(device).manual_seed(seed + rank + 3)
        self.ema_gen = torch.Generator(device).manual_seed(seed + 4)

    def build_target(self, batch: Dict[str, torch.Tensor], r: int):
        """Device-side target: the integer labels (the JSD loss), host-mixed
        soft targets, token-label maps at the token grid r // 16 (their
        sparse dict under AUTOPROG_SPARSE_TL=1 for a loss that takes it), or
        smoothed one-hot rows."""
        if getattr(self.train_loss, "wants_int_labels", False):
            return batch["label"]
        if "soft_target" in batch:
            return batch["soft_target"]
        if self.token_label and self.has_token_label_data and "label_scores" in batch:
            sparse = os.environ.get("AUTOPROG_SPARSE_TL", "0") == "1" and \
                getattr(self.train_loss, "supports_sparse_tl", False)
            build = sparse_token_label_target if sparse else build_token_label_target
            return build(batch["label"], batch["label_scores"], batch["label_inds"],
                         num_classes=self.num_classes, smoothing=self.smoothing,
                         label_size=r // 16, gt_soft=batch.get("gt_soft"))
        return smooth_one_hot(batch["label"], self.num_classes, self.smoothing)

    def prep_images(self, images: torch.Tensor, re_prob: float = 0.0) -> torch.Tensor:
        """A uint8 batch (`--uint8-pipe`) normalised on the device, then
        random-erased where `re_prob` > 0 (training); other batches as they
        are."""
        if images.dtype == torch.uint8:
            images = normalize_uint8(images, self.norm_mean, self.norm_std, torch.float32)
            if re_prob > 0:
                images = random_erase(images, self.erase_gen, prob=re_prob,
                                      count=self.re_count)
        return images

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor], lr: float, *,
                   r: int, keep=None, splits: int = 1,
                   bbox: Optional[torch.Tensor] = None,
                   re_prob: float = 0.0) -> Dict[str, torch.Tensor]:
        """One optimizer update, in place on `state`; returns {"loss"} as a
        device scalar (no host sync). `bbox` injects the MixToken box;
        `re_prob` erases uint8 batches on the device."""
        with spans.span("step"):
            model = state.model
            images = batch["image"]
            mb = images.shape[0] // splits
            with spans.span("step.input"):
                target = self.build_target(batch, r)
                xs = [resize_bilinear(self.prep_images(images[i * mb:(i + 1) * mb], re_prob), r)
                      for i in range(splits)]
                loss_sum = torch.zeros((), device=images.device)
            tb = (target["vals"] if isinstance(target, dict) else target).shape[0] // splits
            for i, x in enumerate(xs):
                out = model(x, train=True, keep=keep, bbox=bbox, drop_gen=self.drop_gen,
                            mix_gen=self.mix_gen)
                with spans.span("step.loss"):
                    loss = self.train_loss(out, _rows(target, slice(i * tb, (i + 1) * tb)))
                    loss_sum += loss.detach()
                with spans.span("step.backward"), spans.backward_segments("model.head"):
                    (loss / splits).backward()
            with spans.span("step.update"):
                self._update(state, lr)
            return {"loss": loss_sum / splits}

    def _update(self, state: TrainState, lr: float) -> None:
        """Everything after the backward: zero gradients where the forward
        did not reach, the all-reduce over the ranks, the clip, the optimizer
        and the EMA sweeps."""
        named = list(state.model.named_parameters())
        params = [p for _, p in named]
        with spans.span("update.fill"):
            # a layer the keep mask skipped has no gradient; jax.grad gives it
            # zeros, so the optimizer steps it (moments, decay, count) as optax does
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                    GRAD_FILLS["params"] += 1
        with spans.span("update.allreduce"):
            if mesh.process_group_active():
                mesh.all_reduce_grads(params)
        with spans.span("update.clip"):
            if self.grad_clip is not None:
                with torch.no_grad():
                    self.grad_clip(named)
        with spans.span("update.optimizer"):
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        with spans.span("update.ema"):
            if self.ema_decays:
                self._update_ema(state, [p.detach() for p in params])
        state.step += 1

    @torch.no_grad()
    def _update_ema(self, state: TrainState, params) -> None:
        """e = d * e + (1 - d) * p for every decay. A bf16 tree
        (`--model-ema-bf16`) accumulates in f32 and is stored by stochastic
        rounding, with a dither sweep of its own per decay and step (round to
        nearest would freeze it). Under tensor parallelism a sharded leaf
        reads its full leaf's dither at its own elements, so the gathered
        tree is the one-process tree's rounding (`ops/rounding.py`)."""
        m, count, specs = mesh.model_index(), mesh.model_count(), None
        for d, ema in zip(self.ema_decays, state.ema_params):
            e = list(ema.values())
            if e[0].dtype != torch.bfloat16:
                torch._foreach_mul_(e, d)
                torch._foreach_add_(e, params, alpha=1.0 - d)
                continue
            e32 = [torch.empty_like(p) for p in params]
            torch._foreach_copy_(e32, e)
            torch._foreach_mul_(e32, d)
            torch._foreach_add_(e32, params, alpha=1.0 - d)
            if specs is None and count > 1:
                specs = [tp.param_spec(k, v.ndim) for k, v in ema.items()]
            cast_bf16_sr(e32, self.ema_gen, out=e, specs=specs, m=m, count=count)

    @staticmethod
    def _eval_logits(state: TrainState, images: torch.Tensor, keep, params) -> torch.Tensor:
        model = state.model
        if params is None:
            logits = model(images, train=False, keep=keep)
        else:
            logits = torch.func.functional_call(model, _widened(params), (images,),
                                                {"train": False, "keep": keep})
        return logits[0] if isinstance(logits, tuple) else logits

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *, keep=None,
                  params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Metric sums of one eval batch; `params` (an EMA tree) replaces the
        model's parameters for this call."""
        return metrics_from_logits(
            self._eval_logits(state, self.prep_images(batch["image"]), keep, params),
            batch["label"])

    @torch.no_grad()
    def logits_eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *,
                         tta: int = 1, keep=None,
                         params: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One forward shared by the metric sums, `--tta` and `--real-labels`:
        with tta > 1 the batch holds `tta` adjacent views of each sample and
        the f32 logits are averaged over each group first. Padding rows
        (label -1, trailing, a whole group each) drop out of every sum.
        Returns (metric sums, argmax per group)."""
        logits = self._eval_logits(state, self.prep_images(batch["image"]), keep,
                                   params).float()
        labels = batch["label"]
        if tta > 1:
            logits = logits.reshape(-1, tta, logits.shape[-1]).mean(1)
            labels = labels[::tta]
        return metrics_from_logits(logits, labels), logits.argmax(-1).int()

    # ------------------------------------------------------- search probes

    def _probe_forward(self, state, images, r, keep, params, drop_gen, mix_gen):
        kwargs = {"train": True, "keep": keep, "drop_gen": drop_gen or self.drop_gen,
                  "mix_gen": mix_gen or self.mix_gen}
        x = resize_bilinear(self.prep_images(images), r)
        if params is None:
            return state.model(x, **kwargs)
        return torch.func.functional_call(state.model, _widened(params), (x,), kwargs)

    @torch.no_grad()
    def loss_probe_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *, r: int,
                        keep=None, params: Optional[Dict[str, torch.Tensor]] = None,
                        drop_gen: Optional[torch.Generator] = None,
                        mix_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Train-mode forward, hard-label CE on the cls logits, batch mean:
        the search loss probe, averaged over the ranks under a process group.
        `params` (an EMA tree) replaces the model's parameters for this
        call. A device scalar; no host sync in one process."""
        with _buffers_restored(state.model):
            out = self._probe_forward(state, batch["image"], r, keep, params,
                                      drop_gen, mix_gen)
        logits = out[0] if isinstance(out, tuple) else out
        return mesh.mean_over_ranks(_ce_per_sample(logits, batch["label"]).mean())

    def throughput_probe_step(self, state: TrainState, batch: Dict[str, torch.Tensor], *,
                              r: int, keep=None,
                              params: Optional[Dict[str, torch.Tensor]] = None,
                              drop_gen: Optional[torch.Generator] = None,
                              mix_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forward + backward of the training loss without an optimizer
        update; the gradients are discarded. Returns the loss (device
        scalar)."""
        if params is not None:
            params = {k: v.detach().requires_grad_(True) for k, v in _widened(params).items()}
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
