"""Fixed-schedule trainer of the port, counterpart of `autoprog_tpu/main.py`.

    python -m autoprog_tpu_torch.main synthetic:// --model volo_d1 \
        --token-label --token-label-data synthetic --model-ema ...

The flags are the port's own `config.py` (a copy of the JAX package's, so
both trainers take the same command line). The device is
`AUTOPROG_TORCH_DEVICE` (default cuda; see platform.py). The tfds/ and hfds/
datasets, whose machinery is not ported, raise NotImplementedError.

`--resume` (either package's checkpoint; then `--start-epoch` overrides the
epoch), `--finetune` and `--initial-checkpoint` are each followed by one
eval pass.

Data parallel across processes, one rank per GPU (`parallel/mesh.py`):

    torchrun --nproc_per_node 8 -m autoprog_tpu_torch.main ...

`-b` is the global batch; each rank loads `-b // world` of it. Only rank 0
makes the output directory, logs and writes checkpoints.

Tensor parallel (`parallel/tp.py`) with `--model-parallel M` (M divides the
world and every head count): the ranks form a (data, model) grid, each
model group of M ranks holds one replica's shards and loads `-b // (world /
M)` rows; checkpoints hold full tensors:

    torchrun --nproc_per_node 8 -m autoprog_tpu_torch.main ... --model-parallel 2
"""

from __future__ import annotations

import logging
import os
import sys

from autoprog_tpu_torch.config import parse_args, resolve_data_config
from autoprog_tpu_torch.utils.logging import make_output_dir, setup_logging, update_summary
from autoprog_tpu_torch.utils.meters import AverageMeter
from autoprog_tpu_torch import engine
from autoprog_tpu_torch.finetune import load_pretrained_weights
from autoprog_tpu_torch.parallel import mesh
from autoprog_tpu_torch.registry import create_model
from autoprog_tpu_torch.train.checkpoint import CheckpointSaver, load_checkpoint_file

_logger = logging.getLogger("autoprog_tpu_torch")


UNPORTED_DATASETS = ("tfds/", "hfds/")


def check_dataset(dataset: str) -> None:
    """Refuse the dataset kinds the port cannot read (no tensorflow_datasets,
    no local HuggingFace data to test against)."""
    if dataset.startswith(UNPORTED_DATASETS):
        raise NotImplementedError(f"--dataset {dataset}: not ported to autoprog_tpu_torch yet")


def check_ported(args) -> None:
    """Refuse flags whose machinery the port does not have yet."""
    check_dataset(args.dataset)


def load_initial_weights(ctx, loader_eval) -> None:
    """--finetune (wins when both are given) or --initial-checkpoint: the
    checkpoint's parameters (its first EMA tree with --model-ema) into the
    model, adapted to its resolution and class count, then one eval pass.
    Only the parameters load, as in the JAX package. Every rank loads."""
    args = ctx.args
    path = args.finetune or args.initial_checkpoint
    load_pretrained_weights(ctx.state.model, path, use_ema=args.model_ema)
    mesh.replicate(ctx.state.model)
    engine.evaluate_all(ctx, loader_eval)


def start_process(args, model_name: str, suffix: str, splits: int) -> str:
    """Join torchrun's process group where there is one and lay out the
    `--model-parallel` grid (a ValueError where M does not divide the
    world); the output directory and the log file on rank 0 (other ranks log
    warnings only, to stderr); the JAX entry points' per-rank batch check.
    Returns the output directory ("" on ranks other than 0)."""
    mesh.maybe_init_distributed()
    mesh.init_grid(getattr(args, "model_parallel", 1))
    output_dir = make_output_dir(args.output, model_name, suffix=suffix) \
        if mesh.is_primary() else ""
    setup_logging(os.path.join(output_dir, "log.txt") if output_dir else "",
                  level=logging.INFO if output_dir else logging.WARNING)
    per_rank = args.batch_size // mesh.data_count()
    if per_rank % splits != 0:
        raise SystemExit(f"per-rank batch size {per_rank} (-b {args.batch_size} over "
                         f"{mesh.data_count()} data ranks) must be divisible by "
                         f"batch splits {splits}")
    return output_dir


def make_saver(args, args_text: str, output_dir: str) -> CheckpointSaver:
    """The checkpoint saver: enabled on rank 0 only, which also writes
    args.yaml."""
    if output_dir:
        with open(os.path.join(output_dir, "args.yaml"), "w") as f:
            f.write(args_text)
    return CheckpointSaver(checkpoint_dir=output_dir or ".",
                           decreasing=(args.eval_metric == "loss"),
                           max_history=args.checkpoint_hist, enabled=bool(output_dir))


def main(argv=None):
    args, args_text = parse_args(argv, prog=False)
    check_ported(args)
    owns_group = not mesh.process_group_active()
    try:
        return _train(args, args_text)
    finally:
        if owns_group:
            mesh.destroy()


def _train(args, args_text):
    output_dir = start_process(args, args.model, "fixed", args.batch_splits)
    # token_label_size follows the resolution BEFORE the loss is selected
    img_size = args.img_size or resolve_data_config(
        args, create_model(args.model).default_cfg)["input_size"][-1]
    args.token_label_size = img_size // 16
    ctx = engine.setup(args, args_text, output_dir=output_dir)
    _logger.info("device: %s", ctx.device)

    loader_train = engine.make_train_loader(ctx, aa=args.aa, re_prob=args.reprob,
                                            resize=args.scale)
    loader_eval = engine.make_eval_loader(ctx)
    ctx.saver = make_saver(args, args_text, output_dir)

    start_epoch = 0
    if args.resume:
        start_epoch = engine.resume_from(ctx, load_checkpoint_file(args.resume))
        if args.start_epoch is not None:
            start_epoch = args.start_epoch
        engine.evaluate_all(ctx, loader_eval)
    elif args.start_epoch is not None:
        start_epoch = args.start_epoch
    if args.finetune or args.initial_checkpoint:
        load_initial_weights(ctx, loader_eval)

    num_epochs = ctx.schedule.num_epochs
    _logger.info("Scheduled epochs: %d", num_epochs)
    epoch_time_m = AverageMeter()
    best_metric = best_epoch = None
    try:
        for epoch in range(start_epoch, num_epochs):
            train_metrics = engine.train_one_epoch(
                ctx, epoch, loader_train, r=img_size, splits=args.batch_splits,
                epoch_time_m=epoch_time_m, re_prob=args.reprob)
            eval_metrics, names = engine.evaluate_all(ctx, loader_eval)
            if hasattr(ctx.schedule, "observe"):  # plateau schedule
                ctx.schedule.observe(max(eval_metrics[n] for n in names))
            if output_dir:
                update_summary(epoch, train_metrics, eval_metrics,
                               os.path.join(output_dir, "summary.csv"),
                               write_header=best_metric is None)
            save_metric = max(eval_metrics[n] for n in names)
            best_metric, best_epoch = ctx.saver.save_checkpoint(
                lambda: engine.ckpt_payload(ctx, {"r": img_size, "stage": 0}), epoch,
                metric=save_metric)
    except KeyboardInterrupt:
        pass
    finally:
        loader_train.close()
        loader_eval.close()
    if best_metric is not None:
        _logger.info("*** Best metric: %s (epoch %s)", best_metric, best_epoch)
    _logger.info("total train time: %.1fs", epoch_time_m.sum)
    return best_metric


if __name__ == "__main__":
    main(sys.argv[1:])
