"""Training engine, counterpart of `autoprog_tpu/engine.py`: `setup`,
`init_model_state`, the train / eval / search loaders, `train_one_epoch`,
`evaluate`, `evaluate_all`, `create_stage_model_and_state`, `ckpt_payload`
and `resume_from`. `main.py` and `main_prog.py` are thin loops over these.

The host input pipeline (datasets, augmentation, mixup, token-label map
cropping) is the port's own `data/` package. Batches arrive as numpy and
move to the device once per step. Losses stay on the device and are read on
the host only at log intervals.

A stage rebuild makes a new model and optimizer (fresh moments, the two
weight-decay groups of `train/optim.py`), remaps the parameters and every
EMA tree into it (`prog/growth.py`); its step count starts again at 0, as
the JAX package's does. The LR schedule is a function of the epoch and is
untouched.

Under a process group (`parallel/mesh.py`) every rank runs all of this on
its share of the batch: the loaders take `-b // world` rows, a strided shard
of the one permutation; the model is built from the run seed and rank 0's
copy is broadcast after every build, rebuild and resume, while the step's
generators are seeded from the seed plus the rank; every rank takes as many
steps an epoch as the rank with the fewest batches; the logged loss and the
eval sums are reduced over the ranks, and only rank 0 logs, writes images
and checkpoints and traces the profile.

Under `--model-parallel M` (`parallel/tp.py`) "the ranks" above mean the data
group: the loaders shard by the data index, so the M ranks of a model group
load the same rows, and the step's generators are seeded from the data index,
so that they drop the same paths. Each rank holds its shard of the blocks:
every build makes the full model from the seed, broadcasts rank 0's over the
world and shards it; a stage rebuild gathers the full trees over the model
group, grows them (`prog/growth.py`) and shards the result, as the JAX package
re-applies `shard_state_tp` after growth; a resume shards the full file, and
a checkpoint gathers its leaves (`train/checkpoint.py`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from autoprog_tpu_torch.config import resolve_data_config
from autoprog_tpu_torch.data.dataset import create_dataset
from autoprog_tpu_torch.data.loader import Loader, create_loader, pad_eval_batch
from autoprog_tpu_torch.data.mixup import Mixup
from autoprog_tpu_torch.data.transforms import TrainTransform
from autoprog_tpu_torch.utils.meters import AverageMeter
from autoprog_tpu_torch.losses import build_train_loss
from autoprog_tpu_torch.parallel import mesh, tp
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.prog.growth import grow_batch_stats, grow_params, shrink_params
from autoprog_tpu_torch.registry import create_model
from autoprog_tpu_torch.train.checkpoint import CheckpointSaver, build_payload, restore_state
from autoprog_tpu_torch.train.optim import create_grad_clip, create_optimizer, create_scheduler
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder
from autoprog_tpu_torch.utils import spans

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
              mix_token=bool(args.token_label), return_dense=bool(args.token_label),
              remat=getattr(args, "remat", ""))
    # --bn-momentum is the torch convention (new = (1-m)*old + m*batch);
    # the model's BatchNorm takes Flax's complement
    if getattr(args, "bn_momentum", None) is not None:
        kw["bn_momentum"] = 1.0 - args.bn_momentum
    if getattr(args, "bn_eps", None) is not None:
        kw["bn_eps"] = args.bn_eps
    return kw


def init_model_state(ctx: TrainContext, model_name: str, dp: float,
                     seed: int) -> Dict[str, torch.Tensor]:
    """Model (random init from `seed`), optimizer, EMA trees and step
    builder for `model_name`, installed in ctx. Returns the full model's
    parameters (this rank's model's own without tensor parallelism): the
    template of a stage rebuild."""
    args = ctx.args
    mdef = create_model(model_name)
    kwargs = model_kwargs(args, dp, ctx.compute_dtype())
    torch.manual_seed(seed)
    model = mdef.make(**kwargs).to(ctx.device)
    mesh.replicate(model, world=True)
    full = {n: p.detach() for n, p in model.named_parameters()}
    if mesh.model_count() > 1:
        buffers = dict(model.named_buffers())
        model = mdef.make(**kwargs, model_parallel=mesh.model_count()).to(ctx.device)
        tp.load_shards(model, full, buffers)
    optimizer = create_optimizer(args, model)
    ema_decays = ctx.ema_decays if args.model_ema else ()
    ema_dtype = torch.bfloat16 if getattr(args, "model_ema_bf16", False) else None
    ctx.state = TrainState.create(model=model, optimizer=optimizer, ema_decays=ema_decays,
                                  ema_dtype=ema_dtype)
    ctx.sb = StepBuilder(
        train_loss=ctx.train_loss, ema_decays=ema_decays,
        num_classes=args.num_classes or 1000, smoothing=args.smoothing,
        token_label=args.token_label, has_token_label_data=bool(args.token_label_data),
        grad_clip=create_grad_clip(args), device=ctx.device, seed=seed,
        rank=mesh.data_index(),
        norm_mean=ctx.data_config["mean"], norm_std=ctx.data_config["std"],
        re_count=getattr(args, "recount", 1))
    ctx.mdef = mdef
    n = sum(p.numel() for p in full.values())
    _logger.info("Model %s created, param count: %d", model_name, n)
    return full


def setup(args, args_text: str, *, prog: bool = False, output_dir: str = "",
          initial_model: Optional[str] = None) -> TrainContext:
    """Common setup of both trainers; `initial_model` is the first stage's
    architecture where it differs from `args.model`. The process grid of
    `--model-parallel` is laid out at the process's start
    (`main.start_process`)."""
    if getattr(args, "model_parallel", 1) != mesh.model_count():
        raise ValueError(f"--model-parallel {args.model_parallel} on a grid of model size "
                         f"{mesh.model_count()} (mesh.init_grid lays it out)")
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


def _shard(batch_size: int) -> Dict[str, int]:
    """This rank's loader arguments: its data group's share of the global
    batch and its place in the data axis (the ranks of a model group load the
    same rows)."""
    return dict(batch_size=max(batch_size // mesh.data_count(), 1),
                process_index=mesh.data_index(), process_count=mesh.data_count())


def make_train_loader(ctx: TrainContext, *, aa: str, re_prob: float, resize,
                      batch_size: Optional[int] = None) -> Loader:
    """Train loader at the full eval resolution; the step resizes on the
    device to the stage resolution. `batch_size` (default `-b`) is global."""
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
    loader = create_loader(
        ds, input_size=ctx.data_config["input_size"][-1],
        **_shard(batch_size or args.batch_size), is_training=True, re_prob=re_prob,
        re_mode=args.remode, re_count=args.recount, scale=resize, ratio=args.ratio,
        hflip=args.hflip, vflip=args.vflip, color_jitter=args.color_jitter,
        auto_augment=aa, interpolation=args.train_interpolation,
        mean=ctx.data_config["mean"], std=ctx.data_config["std"],
        num_workers=args.workers, mixup=mixup, seed=args.seed, no_aug=args.no_aug)
    uint8 = getattr(args, "uint8_pipe", False)
    if uint8:
        # uint8 to the device; normalise and random-erase in the step
        loader.transform.emit_uint8 = True
        loader.transform.re_prob = 0.0
    if getattr(args, "aug_splits", 0) > 1:
        loader.aug_splits = args.aug_splits
        loader.clean_transform = TrainTransform(
            size=ctx.data_config["input_size"][-1], scale=tuple(resize),
            ratio=tuple(args.ratio), hflip=args.hflip, vflip=args.vflip,
            interpolation=args.train_interpolation, mean=ctx.data_config["mean"],
            std=ctx.data_config["std"])
        # both splits emit one dtype: a float clean split stacked with
        # uint8 aug splits would skip the in-step normalisation
        loader.clean_transform.emit_uint8 = uint8
    return loader


def make_eval_loader(ctx: TrainContext) -> Loader:
    args = ctx.args
    ds = create_dataset(args.dataset, args.data_dir, split=args.val_split,
                        is_training=False, num_classes=args.num_classes,
                        fake_size=max(args.fake_data_size // 4, 64),
                        image_size=ctx.data_config["input_size"][-1], seed=args.seed,
                        dataset_size=getattr(args, "dataset_size", 0))
    loader = create_loader(
        ds, input_size=ctx.data_config["input_size"][-1],
        **_shard(args.validation_batch_size_multiplier * args.batch_size),
        is_training=False, crop_pct=ctx.data_config["crop_pct"],
        interpolation=ctx.data_config["interpolation"], mean=ctx.data_config["mean"],
        std=ctx.data_config["std"], num_workers=args.workers)
    loader.transform.emit_uint8 = getattr(args, "uint8_pipe", False)
    return loader


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
        ds, input_size=ctx.data_config["input_size"][-1], **_shard(max(batch, 1)),
        is_training=True, re_prob=0.0, scale=args.scale, ratio=args.ratio,
        hflip=args.hflip, vflip=args.vflip, auto_augment=args.aa,
        interpolation=args.train_interpolation, mean=ctx.data_config["mean"],
        std=ctx.data_config["std"], num_workers=0, seed=args.seed)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


# --------------------------------------------------------------- epoch loops


def epoch_batches(loader: Loader):
    """(steps, iterator of (index, batch)) for one epoch. In one process,
    every batch the loader yields; under a process group, as many as the
    rank with the fewest batches has (strided shards differ by up to one
    sample), so that every rank reaches every collective."""
    if not mesh.process_group_active():
        return len(loader), enumerate(loader)
    nb = mesh.min_over_ranks(len(loader))
    return nb, zip(range(nb), loader)


def device_re_prob(args, re_prob: float) -> float:
    """The random-erase probability of the step: the stage's under
    `--uint8-pipe` (the loader then erases nothing), else 0."""
    return re_prob if getattr(args, "uint8_pipe", False) else 0.0


class _Profile:
    """`--profile DIR`: a `torch.profiler` trace (CPU and, on a card, CUDA
    activity) of the steps of epoch 0 from batch 1 (past the first step's
    warm-up) to batch min(profile_steps, nb - 2), as the JAX package's
    `jax.profiler` trace; written to DIR as a Chrome trace. The trace shows
    the program's spans (`utils/spans.py`: the step's segments, forward and
    backward, `train.data_wait` and `train.to_device`) above the kernels."""

    def __init__(self, args, device: torch.device, epoch: int, nb: int):
        self.dir = getattr(args, "profile", "") if epoch == 0 and mesh.is_primary() else ""
        self.stop_at = min(getattr(args, "profile_steps", 10), max(nb - 2, 1))
        self.device = device
        self.prof = None

    def before(self, batch_idx: int) -> None:
        if self.dir and batch_idx == 1:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, batch_idx: int) -> None:
        if self.prof is not None and batch_idx == self.stop_at:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace-{os.getpid()}-{int(time.time())}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        _logger.info("profiler trace written to %s", path)


def _waited(batches):
    """The batches, each fetched inside a `train.data_wait` span (the wait
    that `data_time` meters)."""
    it = iter(batches)
    while True:
        with spans.span("train.data_wait"):
            item = next(it, None)
        if item is None:
            return
        yield item


def train_one_epoch(ctx: TrainContext, epoch: int, loader: Loader, *, r: int,
                    keep=None, splits: int = 1,
                    epoch_time_m: Optional[AverageMeter] = None,
                    re_prob: float = 0.0) -> Dict[str, float]:
    """One epoch of the hot loop; `re_prob` is the stage's random-erase
    probability (applied in the step under `--uint8-pipe`)."""
    args = ctx.args
    device_re = device_re_prob(args, re_prob)
    lr = ctx.schedule.fn(epoch)
    loader.set_epoch(epoch)
    if args.mixup_off_epoch and epoch >= args.mixup_off_epoch and loader.mixup is not None:
        loader.mixup.enabled = False
    data_time = AverageMeter()
    loss_sum = None
    n_steps = 0
    nb, batches = epoch_batches(loader)
    world = mesh.data_count()
    end = epoch_start = time.time()
    last_log_idx, last_log_t = 0, end
    profile = _Profile(args, ctx.device, epoch, nb)
    try:
        for batch_idx, batch in _waited(batches):
            profile.before(batch_idx)
            data_time.update(time.time() - end)
            with spans.span("train.to_device"):
                on_device = to_device(batch, ctx.device)
            metrics = ctx.sb.train_step(ctx.state, on_device, lr,
                                        r=r, keep=keep, splits=splits, re_prob=device_re)
            loss_sum = metrics["loss"] if loss_sum is None else loss_sum + metrics["loss"]
            n_steps += 1
            profile.after(batch_idx)
            if batch_idx % args.log_interval == 0 or batch_idx == nb - 1:
                loss = float(mesh.mean_over_ranks(metrics["loss"]))   # host sync
                now = time.time()
                steps = batch_idx - last_log_idx
                rate = (batch["label"].shape[0] * world * steps / max(now - last_log_t, 1e-9)
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
                    ctx.saver.save_recovery(lambda: ckpt_payload(ctx, {}), epoch, batch_idx)
            end = time.time()
    finally:
        profile.close()
    if nb < len(loader):
        loader.close()          # stop the pool from finishing the abandoned epoch
    if epoch_time_m is not None:
        epoch_time_m.update(time.time() - epoch_start)
    if not n_steps:
        return {"loss": float("nan")}
    return {"loss": float(mesh.mean_over_ranks(loss_sum)) / n_steps}


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
    once at the end (summed over the data group first: every rank must call
    it).
    Partial final batches pad to the full batch size."""
    keys = ("loss_sum", "top1_sum", "top5_sum", "count")
    acc = {k: torch.zeros((), device=ctx.device) for k in keys}
    for batch in loader:
        batch = to_device(pad_eval_batch(batch, loader.batch_size), ctx.device)
        m = ctx.sb.eval_step(ctx.state, batch, keep=keep, params=params)
        acc = {k: acc[k] + m[k] for k in keys}
    if mesh.process_group_active():
        acc = dict(zip(keys, mesh.all_reduce_sum([acc[k] for k in keys])))
    sums = {k: float(v) for k, v in acc.items()}
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
    the weights and every EMA tree, reset the optimizer moments and the
    step count (as the JAX package's fresh `TrainState` does), keep the
    global LR schedule."""
    args = ctx.args
    prev_state = ctx.state
    prev_layers = tuple(ctx.mdef.arch.layers)
    # under tensor parallelism the remappers work on the full trees
    prev_params = tp.gather_local({n: p.detach() for n, p in prev_state.params.items()})
    prev_ema = tuple(tp.gather_local(e) for e in prev_state.ema_params)

    template = init_model_state(ctx, new_model_name, dp, args.seed + 1000 + seed_offset)
    ema_templates = [tp.gather_local(e) for e in ctx.state.ema_params]
    new_layers = tuple(ctx.mdef.arch.layers)
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
        new_ema = tuple(grow_params(e, ema_templates[i], mode="clone", **grow)
                        for i, e in enumerate(prev_ema))
    elif load == "super":
        shrink = dict(base_layers=new_layers, super_layers=prev_layers,
                      dst_layers=new_layers, base_l=origin_l, super_l=sum(prev_layers),
                      dst_l=sum(new_layers), family=getattr(ctx.mdef.arch, "family", "volo"))
        new_params = shrink_params(prev_params, template, **shrink)
        new_ema = tuple(shrink_params(e, ema_templates[i], **shrink)
                        for i, e in enumerate(prev_ema))
    elif load == "":
        return  # fresh init
    else:
        raise ValueError(f"unknown load mode {load!r}")

    new_stats = grow_batch_stats(prev_state.batch_stats, ctx.state.batch_stats, **grow)
    # in place (the new optimizer already holds these parameters), this
    # rank's shards under tensor parallelism
    tp.load_shards(ctx.state.model, new_params, new_stats)
    ctx.state.ema_params = tuple(tp.shard_tree(e) for e in new_ema)
    mesh.replicate(ctx.state.model, *ctx.state.ema_params)


def ckpt_payload(ctx: TrainContext, stage_info: Dict[str, Any]) -> Dict[str, Any]:
    payload = build_payload(state=ctx.state, args_text=ctx.args_text,
                            arch_name=ctx.mdef.name, stage_info=stage_info)
    if hasattr(ctx.schedule, "state_dict"):  # plateau schedule state
        payload["lr_schedule"] = ctx.schedule.state_dict()
    return payload


def resume_from(ctx: TrainContext, ckpt: Dict[str, Any]) -> int:
    """Progressive-aware resume from a loaded payload (`load_checkpoint_file`,
    either package's file): rebuild the checkpoint's arch (with its stage's
    drop-path) where it differs from the current one, restore weights, BN
    stats, optimizer (unless --no-resume-opt), EMA trees, step and the
    plateau schedule's state. Returns the epoch to resume at."""
    arch = ckpt.get("arch")
    if arch and arch != ctx.mdef.name:
        stage_info = ckpt.get("stage_info") or {}
        init_model_state(ctx, arch, float(stage_info.get("dp", 0.0)), ctx.args.seed)
    ckpt = tp.shard_payload(ckpt, ctx.state.model, ctx.state.optimizer)
    restore_state(ckpt, ctx.state, restore_opt=not ctx.args.no_resume_opt)
    mesh.replicate(ctx.state.model, *ctx.state.ema_params)
    if hasattr(ctx.schedule, "load_state_dict") and "lr_schedule" in ckpt:
        ctx.schedule.load_state_dict(ckpt["lr_schedule"])
    return int(ckpt.get("epoch", -1)) + 1
