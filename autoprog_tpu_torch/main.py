"""Fixed-schedule trainer of the port, counterpart of `autoprog_tpu/main.py`.

    python -m autoprog_tpu_torch.main synthetic:// --model volo_d1 \
        --token-label --token-label-data synthetic --model-ema ...

The flags are the port's own `config.py` (a copy of the JAX package's, so
both trainers take the same command line). The device is
`AUTOPROG_TORCH_DEVICE` (default cuda; see platform.py). Every dataset kind
of the copied `data/dataset.py` reads: `hfds/<name>` a HuggingFace dataset
saved to disk (the positional data path), `tfds/<name>` only where
tensorflow_datasets is installed (else its ImportError).

`--resume` (either package's checkpoint; then `--start-epoch` overrides the
epoch), `--finetune` and `--initial-checkpoint` are each followed by one
eval pass. The log's last line counts the run's K1 / K2 launches
(`kernel launches: {...}`; all 0 on the CPU, where the plain twins run);
main_prog.py logs the same.

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
from autoprog_tpu_torch.ops import launch_counts, launches_since
from autoprog_tpu_torch.parallel import mesh
from autoprog_tpu_torch.registry import create_model
from autoprog_tpu_torch.train.checkpoint import CheckpointSaver, load_checkpoint_file

_logger = logging.getLogger("autoprog_tpu_torch")


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


def decodes_jpegs(dataset: str, root: str) -> bool:
    """Whether the loader decodes JPEG files or records itself (an
    ImageFolder, token-label data, `tfrecord`), where the native decoder
    applies; generated data, `tfds/` and `hfds/` bring their own images."""
    return not (dataset in ("synthetic", "procgen") or dataset.startswith(("tfds/", "hfds/"))
                or root.startswith(("synthetic://", "procgen://")))


def check_native_decoder(args) -> None:
    """With loader workers on JPEG data, make sure the native decoder
    (`native/libfastimage.so`) loads: build it where it is missing
    (`_build.build_native_image`; the card's host has no libjpeg development
    files for `native/Makefile`) and raise where it does not load. The copied
    pipeline would otherwise decode with PIL without a word, at about two
    thirds of the native rate (PERF.md, section 3). `AUTOPROG_NO_NATIVE=1`
    asks for PIL, and then nothing is checked."""
    if (args.workers <= 0 or os.environ.get("AUTOPROG_NO_NATIVE") == "1"
            or not decodes_jpegs(args.dataset, args.data_dir)):
        return
    from autoprog_tpu_torch._build import build_native_image
    from autoprog_tpu_torch.data import native
    path = build_native_image()
    if not native.available():
        raise RuntimeError(f"the native JPEG decoder ({path}) did not load; "
                           "set AUTOPROG_NO_NATIVE=1 to decode with PIL")
    _logger.info("JPEG decode: native (%s)", path)


def start_process(args, model_name: str, suffix: str, splits: int) -> str:
    """Join torchrun's process group where there is one and lay out the
    `--model-parallel` grid (a ValueError where M does not divide the
    world); the output directory and the log file on rank 0 (other ranks log
    warnings only, to stderr); the JAX entry points' per-rank batch check;
    the native JPEG decoder where the loader's workers need it
    (`check_native_decoder`). Returns the output directory ("" on ranks
    other than 0)."""
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
    check_native_decoder(args)
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
    owns_group = not mesh.process_group_active()
    try:
        return _train(args, args_text)
    finally:
        if owns_group:
            mesh.destroy()


def _train(args, args_text):
    launches_at_start = launch_counts()
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
    _logger.info("kernel launches: %s", launches_since(launches_at_start))
    return best_metric


if __name__ == "__main__":
    main(sys.argv[1:])
