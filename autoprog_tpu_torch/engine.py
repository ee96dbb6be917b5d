"""Training engine, counterpart of `autoprog_tpu/engine.py`: `setup`,
`init_model_state`, the train / eval / search loaders, `train_one_epoch`,
`evaluate`, `evaluate_all`, `create_stage_model_and_state` and
`ckpt_payload`. `main.py` and `main_prog.py` are thin loops over these.

The host input pipeline (datasets, augmentation, mixup, token-label map
cropping) is the port's own `data/` package. Batches arrive as numpy and
move to the device once per step. Losses stay on the device and are read on
the host only at log intervals.

A stage rebuild makes a new model and optimizer (fresh moments, the two
weight-decay groups of `train/optim.py`), remaps the parameters and every
EMA tree into it (`prog/growth.py`) and carries the step count on; the LR
schedule is a function of the epoch and is untouched. Resume is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from autoprog_tpu_torch.config import resolve_data_config
from autoprog_tpu_torch.data.dataset import create_dataset
from autoprog_tpu_torch.data.loader import Loader, create_loader, pad_eval_batch
from autoprog_tpu_torch.data.mixup import Mixup
from autoprog_tpu_torch.utils.meters import AverageMeter
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.prog.growth import grow_batch_stats, grow_params, shrink_params
from autoprog_tpu_torch.registry import create_model
from autoprog_tpu_torch.train.checkpoint import CheckpointSaver, build_payload
from autoprog_tpu_torch.train.optim import create_grad_clip, create_optimizer, create_scheduler
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder

_logger = logging.getLogger("autoprog_tpu_torch")


@dataclasses.dataclass
class TrainContext:
    args: Any
    device: torch.device
    data_config: Dict[str, Any]
    schedule: Any
    ema_decays: Tuple[float, ...]
    train_loss: Any
    mdef: Any = None
    sb: Optional[StepBuilder] = None
    state: Optional[TrainState] = None
    saver: Optional[CheckpointSaver] = None
    args_text: str = ""
    output_dir: str = ""
    stage_history: Optional[List[Dict[str, Any]]] = None

    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.args.no_bf16 else torch.bfloat16


def model_kwargs(args, dp: float, dtype) -> Dict[str, Any]:
    kw = dict(num_classes=args.num_classes or 1000, img_size=(args.img_size or 224),
              drop_rate=args.drop, drop_path_rate=dp, dtype=dtype,
              mix_token=bool(args.token_label), return_dense=bool(args.token_label))
    # --bn-momentum is the torch convention (new = (1-m)*old + m*batch);
    # the model's BatchNorm takes Flax's complement
    if getattr(args, "bn_momentum", None) is not None:
        kw["bn_momentum"] = 1.0 - args.bn_momentum
    if getattr(args, "bn_eps", None) is not None:
        kw["bn_eps"] = args.bn_eps
    return kw


def init_model_state(ctx: TrainContext, model_name: str, dp: float, seed: int) -> None:
    """Model (random init from `seed`), optimizer, EMA trees and step
    builder for `model_name`, installed in ctx."""
    args = ctx.args
    mdef = create_model(model_name)
    torch.manual_seed(seed)
    model = mdef.make(**model_kwargs(args, dp, ctx.compute_dtype())).to(ctx.device)
    optimizer = create_optimizer(args, model)
    ema_decays = ctx.ema_decays if args.model_ema else ()
    ctx.state = TrainState.create(model=model, optimizer=optimizer, ema_decays=ema_decays)
    ctx.sb = StepBuilder(
        train_loss=ctx.train_loss, ema_decays=ema_decays,
        num_classes=args.num_classes or 1000, smoothing=args.smoothing,
        token_label=args.token_label, has_token_label_data=bool(args.token_label_data),
        grad_clip=create_grad_clip(args), device=ctx.device, seed=seed)
    ctx.mdef = mdef
    n = sum(p.numel() for p in model.parameters())
    _logger.info("Model %s created, param count: %d", model_name, n)


def setup(args, args_text: str, *, prog: bool = False, output_dir: str = "",
          initial_model: Optional[str] = None) -> TrainContext:
    """Common setup of both trainers; `initial_model` is the first stage's
    architecture where it differs from `args.model`."""
    device = default_device()
    if args.num_classes is None:
        args.num_classes = 1000
    name = initial_model or args.model
    ctx = TrainContext(
        args=args, device=device,
        data_config=resolve_data_config(args, create_model(name).default_cfg),
        schedule=create_scheduler(args),
        ema_decays=tuple(args.model_ema_decay) if args.model_ema else (),
        train_loss=build_train_loss(args), args_text=args_text, output_dir=output_dir)
    init_model_state(ctx, name, args.drop_path or 0.0, args.seed)
    return ctx


# ------------------------------------------------------------------ loaders


def make_train_loader(ctx: TrainContext, *, aa: str, re_prob: float, resize,
                      batch_size: Optional[int] = None) -> Loader:
    """Train loader at the full eval resolution; the step resizes on the
    device to the stage resolution."""
    args = ctx.args
    ds = create_dataset(
        args.dataset, args.data_dir, split=args.train_split, is_training=True,
        token_label_root=args.token_label_data, num_classes=args.num_classes,
        fake_size=args.fake_data_size, image_size=ctx.data_config["input_size"][-1],
        seed=args.seed, dataset_size=getattr(args, "dataset_size", 0))
    mixup_active = args.mixup > 0 or args.cutmix > 0 or args.cutmix_minmax is not None
    mixup = Mixup(mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
                  cutmix_minmax=args.cutmix_minmax, prob=args.mixup_prob,
                  switch_prob=args.mixup_switch_prob, label_smoothing=args.smoothing,
                  num_classes=args.num_classes, mode=args.mixup_mode,
                  token_label=bool(args.token_label_data)) if mixup_active else None
    return create_loader(
        ds, input_size=ctx.data_config["input_size"][-1],
        batch_size=batch_size or args.batch_size, is_training=True, re_prob=re_prob,
        re_mode=args.remode, re_count=args.recount, scale=resize, ratio=args.ratio,
        hflip=args.hflip, vflip=args.vflip, color_jitter=args.color_jitter,
        auto_augment=aa, interpolation=args.train_interpolation,
        mean=ctx.data_config["mean"], std=ctx.data_config["std"],
        num_workers=args.workers, mixup=mixup, seed=args.seed, no_aug=args.no_aug)


def make_eval_loader(ctx: TrainContext) -> Loader:
    args = ctx.args
    ds = create_dataset(args.dataset, args.data_dir, split=args.val_split,
                        is_training=False, num_classes=args.num_classes,
                        fake_size=max(args.fake_data_size // 4, 64),
                        image_size=ctx.data_config["input_size"][-1], seed=args.seed,
                        dataset_size=getattr(args, "dataset_size", 0))
    return create_loader(
        ds, input_size=ctx.data_config["input_size"][-1],
        batch_size=args.validation_batch_size_multiplier * args.batch_size,
        is_training=False, crop_pct=ctx.data_config["crop_pct"],
        interpolation=ctx.data_config["interpolation"], mean=ctx.data_config["mean"],
        std=ctx.data_config["std"], num_workers=args.workers)


def make_search_loader(ctx: TrainContext) -> Loader:
    """Fixed-augmentation loader for comparable search loss probes. Inline
    (no worker pool): it only ever yields the few probe batches of
    `prog/autogrow.py:take_probe_batches`."""
    args = ctx.args
    ds = create_dataset(
        args.dataset, args.data_dir, split=args.train_split, is_training=True,
        fixed_aug=True, token_label_root=args.token_label_data,
        num_classes=args.num_classes, fake_size=args.fake_data_size,
        image_size=ctx.data_config["input_size"][-1], seed=args.seed,
        dataset_size=getattr(args, "dataset_size", 0))
    batch = max(args.batch_size // max(args.batch_splits_list[-1], 1), 1) \
        if hasattr(args, "batch_splits_list") else args.batch_size
    return create_loader(
        ds, input_size=ctx.data_config["input_size"][-1], batch_size=max(batch, 1),
        is_training=True, re_prob=0.0, scale=args.scale, ratio=args.ratio,
        hflip=args.hflip, vflip=args.vflip, auto_augment=args.aa,
        interpolation=args.train_interpolation, mean=ctx.data_config["mean"],
        std=ctx.data_config["std"], num_workers=0, seed=args.seed)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


# --------------------------------------------------------------- epoch loops


def train_one_epoch(ctx: TrainContext, epoch: int, loader: Loader, *, r: int,
                    keep=None, splits: int = 1,
                    epoch_time_m: Optional[AverageMeter] = None) -> Dict[str, float]:
    """One epoch of the hot loop."""
    args = ctx.args
    lr = ctx.schedule.fn(epoch)
    loader.set_epoch(epoch)
    if args.mixup_off_epoch and epoch >= args.mixup_off_epoch and loader.mixup is not None:
        loader.mixup.enabled = False
    data_time = AverageMeter()
    loss_sum = None
    n_steps = 0
    nb = len(loader)
    end = epoch_start = time.time()
    last_log_idx, last_log_t = 0, end
    for batch_idx, batch in enumerate(loader):
        data_time.update(time.time() - end)
        metrics = ctx.sb.train_step(ctx.state, to_device(batch, ctx.device), lr,
                                    r=r, keep=keep, splits=splits)
        loss_sum = metrics["loss"] if loss_sum is None else loss_sum + metrics["loss"]
        n_steps += 1
        if batch_idx % args.log_interval == 0 or batch_idx == nb - 1:
            loss = float(metrics["loss"])               # host sync
            now = time.time()
            steps = batch_idx - last_log_idx
            rate = (batch["label"].shape[0] * steps / max(now - last_log_t, 1e-9)
                    if steps else 0.0)
            _logger.info("Train: %d [%4d/%d]  Loss: %.4f  LR: %.3e  %.1f img/s  "
                         "Data: %.3fs", epoch, batch_idx, nb, loss, lr, rate,
                         data_time.avg)
            last_log_idx, last_log_t = batch_idx, now
            if args.save_images and ctx.output_dir and batch_idx == 0:
                _save_image_grid(batch["image"], f"{ctx.output_dir}/train-batch-{epoch}.jpg",
                                 ctx.data_config)
            if ctx.saver is not None and args.recovery_interval and \
                    (batch_idx + 1) % args.recovery_interval == 0:
                ctx.saver.save_recovery(ckpt_payload(ctx, {}), epoch, batch_idx)
        end = time.time()
    if epoch_time_m is not None:
        epoch_time_m.update(time.time() - epoch_start)
    return {"loss": float(loss_sum) / n_steps if n_steps else float("nan")}


def _save_image_grid(images, path: str, data_config) -> None:
    """Debug dump of the (normalized) input batch (`--save-images`)."""
    from PIL import Image
    x = np.asarray(images[:16]).astype(np.float32)
    x = x * np.asarray(data_config["std"]) + np.asarray(data_config["mean"])
    x = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    n, h, w, _ = x.shape
    cols = 4
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = x[i]
    Image.fromarray(grid).save(path, quality=90)


def evaluate(ctx: TrainContext, loader: Loader, *, keep=None, params=None,
             log_suffix: str = "") -> Dict[str, float]:
    """Validation loop: top-1 / top-5 / loss, summed on the device and read
    once at the end. Partial final batches pad to the full batch size."""
    acc = None
    for batch in loader:
        batch = to_device(pad_eval_batch(batch, loader.batch_size), ctx.device)
        m = ctx.sb.eval_step(ctx.state, batch, keep=keep, params=params)
        acc = m if acc is None else {k: acc[k] + m[k] for k in acc}
    sums = {k: float(v) for k, v in acc.items()} if acc is not None else \
        {"loss_sum": 0.0, "top1_sum": 0.0, "top5_sum": 0.0, "count": 0.0}
    n = max(sums["count"], 1.0)
    metrics = {"loss" + log_suffix: sums["loss_sum"] / n,
               "top1" + log_suffix: 100.0 * sums["top1_sum"] / n,
               "top5" + log_suffix: 100.0 * sums["top5_sum"] / n}
    _logger.info("Test%s: loss %.4f  Acc@1 %.4f  Acc@5 %.4f", log_suffix,
                 metrics["loss" + log_suffix], metrics["top1" + log_suffix],
                 metrics["top5" + log_suffix])
    return metrics


def evaluate_all(ctx: TrainContext, loader: Loader, *, keep=None
                 ) -> Tuple[Dict[str, float], List[str]]:
    """The model and every EMA tree; returns metrics and the names eligible
    for checkpoint ranking."""
    eval_metric = ctx.args.eval_metric
    metrics = evaluate(ctx, loader, keep=keep)
    names = [eval_metric]
    for i, d in enumerate(ctx.sb.ema_decays):
        suffix = f"_EMA_{d}"
        metrics.update(evaluate(ctx, loader, keep=keep, params=ctx.state.ema_params[i],
                                log_suffix=suffix))
        names.append(eval_metric + suffix)
    return metrics, names


# ------------------------------------------------------------- stage rebuild


def create_stage_model_and_state(ctx: TrainContext, new_model_name: str, *, dp: float,
                                 load: str, origin_l: int = 0,
                                 seed_offset: int = 0) -> None:
    """Grow or shrink into a new architecture: build the new model, remap
    the weights and every EMA tree, reset the optimizer moments, keep the
    step count and the global LR schedule."""
    args = ctx.args
    prev_state = ctx.state
    prev_layers = tuple(ctx.mdef.arch.layers)
    prev_params = {n: p.detach() for n, p in prev_state.params.items()}
    prev_ema = prev_state.ema_params

    init_model_state(ctx, new_model_name, dp, args.seed + 1000 + seed_offset)
    new_layers = tuple(ctx.mdef.arch.layers)
    template = {n: p.detach() for n, p in ctx.state.params.items()}
    grow = dict(src_layers=prev_layers, dst_layers=new_layers)

    if load == "slice":
        explicit = getattr(args, "grow_mode", "")
        noise_rng = torch.Generator().manual_seed(args.seed + 777)
        if explicit:
            _logger.info("growing model with explicit mode %r", explicit)
            kw, src = {}, prev_params
            if explicit == "clone_ema":
                if len(prev_ema) <= 3:
                    raise SystemExit("--grow-mode clone_ema needs >= 4 EMA decays")
                kw, src = dict(ema_trees=list(prev_ema[:3])), prev_ema[3]
            if explicit == "clone_noise":
                kw = dict(rng=noise_rng)
            new_params = grow_params(src, template, mode=explicit, **grow, **kw)
        elif args.load_with_clone_ema and len(prev_ema) > 3:
            _logger.info("growing model with clone-ema stitching")
            new_params = grow_params(prev_ema[3], template, mode="clone_ema",
                                     ema_trees=list(prev_ema[:3]), **grow)
        elif args.load_with_clone or args.load_with_clone_ema:
            _logger.info("growing model with clone+noise")
            new_params = grow_params(prev_params, template, mode="clone_noise",
                                     rng=noise_rng, **grow)
        else:
            new_params = grow_params(prev_params, template, mode="clone", **grow)
        # each EMA tree grows against its own template
        new_ema = tuple(grow_params(e, ctx.state.ema_params[i], mode="clone", **grow)
                        for i, e in enumerate(prev_ema))
    elif load == "super":
        shrink = dict(base_layers=new_layers, super_layers=prev_layers,
                      dst_layers=new_layers, base_l=origin_l, super_l=sum(prev_layers),
                      dst_l=sum(new_layers), family=getattr(ctx.mdef.arch, "family", "volo"))
        new_params = shrink_params(prev_params, template, **shrink)
        new_ema = tuple(shrink_params(e, ctx.state.ema_params[i], **shrink)
                        for i, e in enumerate(prev_ema))
    elif load == "":
        return  # fresh init
    else:
        raise ValueError(f"unknown load mode {load!r}")

    new_stats = grow_batch_stats(prev_state.batch_stats, ctx.state.batch_stats, **grow)
    with torch.no_grad():
        # in place: the new optimizer already holds these parameters
        for n, p in ctx.state.model.named_parameters():
            p.copy_(new_params[n])
        for n, b in ctx.state.model.named_buffers():
            b.copy_(new_stats[n])
    ctx.state.ema_params = new_ema
    ctx.state.step = prev_state.step


def ckpt_payload(ctx: TrainContext, stage_info: Dict[str, Any]) -> Dict[str, Any]:
    payload = build_payload(state=ctx.state, args_text=ctx.args_text,
                            arch_name=ctx.mdef.name, stage_info=stage_info)
    if hasattr(ctx.schedule, "state_dict"):  # plateau schedule state
        payload["lr_schedule"] = ctx.schedule.state_dict()
    return payload
