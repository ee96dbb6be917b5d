"""Fixed-schedule trainer of the port, counterpart of `autoprog_tpu/main.py`.

    python -m autoprog_tpu_torch.main synthetic:// --model volo_d1 \
        --token-label --token-label-data synthetic --model-ema ...

The flags are the port's own `config.py` (a copy of the JAX package's, so
both trainers take the same command line). The device is
`AUTOPROG_TORCH_DEVICE` (default cuda; see platform.py). Flags whose
machinery is not ported raise NotImplementedError naming the flag.
"""

from __future__ import annotations

import logging
import os
import sys

from autoprog_tpu_torch.config import parse_args, resolve_data_config
from autoprog_tpu_torch.utils.logging import make_output_dir, setup_logging, update_summary
from autoprog_tpu_torch.utils.meters import AverageMeter
from autoprog_tpu_torch import engine
from autoprog_tpu_torch.registry import create_model
from autoprog_tpu_torch.train.checkpoint import CheckpointSaver

_logger = logging.getLogger("autoprog_tpu_torch")


def check_ported(args) -> None:
    """Refuse flags whose machinery the port does not have yet."""
    refused = [
        ("--resume", bool(args.resume)),
        ("--finetune", bool(args.finetune)),
        ("--initial-checkpoint", bool(getattr(args, "initial_checkpoint", ""))),
        ("--model-parallel", getattr(args, "model_parallel", 1) > 1),
        ("--remat", bool(getattr(args, "remat", ""))),
        ("--model-ema-bf16", getattr(args, "model_ema_bf16", False)),
        ("--adam-mu-bf16", getattr(args, "adam_mu_bf16", False)),
        ("--uint8-pipe", getattr(args, "uint8_pipe", False)),
        ("--aug-splits", getattr(args, "aug_splits", 0) > 1),
        ("--profile", bool(getattr(args, "profile", ""))),
        ("--dataset " + str(args.dataset),
         args.dataset not in ("", "synthetic", "folder")),
        (args.data_dir, args.data_dir.startswith("procgen://")),
    ]
    for flag, hit in refused:
        if hit:
            raise NotImplementedError(f"{flag}: not ported to autoprog_tpu_torch yet")


def main(argv=None):
    args, args_text = parse_args(argv, prog=False)
    check_ported(args)
    output_dir = make_output_dir(args.output, args.model, suffix="fixed")
    setup_logging(os.path.join(output_dir, "log.txt"))
    if args.batch_size % args.batch_splits != 0:
        raise SystemExit(f"batch size {args.batch_size} must be divisible by "
                         f"--batch-splits {args.batch_splits}")
    # token_label_size follows the resolution BEFORE the loss is selected
    img_size = args.img_size or resolve_data_config(
        args, create_model(args.model).default_cfg)["input_size"][-1]
    args.token_label_size = img_size // 16
    ctx = engine.setup(args, args_text, output_dir=output_dir)
    _logger.info("device: %s", ctx.device)

    loader_train = engine.make_train_loader(ctx, aa=args.aa, re_prob=args.reprob,
                                            resize=args.scale)
    loader_eval = engine.make_eval_loader(ctx)
    ctx.saver = CheckpointSaver(checkpoint_dir=output_dir,
                                decreasing=(args.eval_metric == "loss"),
                                max_history=args.checkpoint_hist)
    with open(os.path.join(output_dir, "args.yaml"), "w") as f:
        f.write(args_text)

    start_epoch = args.start_epoch or 0
    num_epochs = ctx.schedule.num_epochs
    _logger.info("Scheduled epochs: %d", num_epochs)
    epoch_time_m = AverageMeter()
    best_metric = best_epoch = None
    try:
        for epoch in range(start_epoch, num_epochs):
            train_metrics = engine.train_one_epoch(
                ctx, epoch, loader_train, r=img_size, splits=args.batch_splits,
                epoch_time_m=epoch_time_m)
            eval_metrics, names = engine.evaluate_all(ctx, loader_eval)
            if hasattr(ctx.schedule, "observe"):  # plateau schedule
                ctx.schedule.observe(max(eval_metrics[n] for n in names))
            update_summary(epoch, train_metrics, eval_metrics,
                           os.path.join(output_dir, "summary.csv"),
                           write_header=best_metric is None)
            save_metric = max(eval_metrics[n] for n in names)
            best_metric, best_epoch = ctx.saver.save_checkpoint(
                engine.ckpt_payload(ctx, {"r": img_size, "stage": 0}), epoch,
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
