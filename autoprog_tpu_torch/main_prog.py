"""Progressive + AutoProg trainer of the port, counterpart of
`autoprog_tpu/main_prog.py`.

    python -m autoprog_tpu_torch.main_prog synthetic:// --model volo_d1 \
        --num-stages 4 --auto-grow --load-with-clone-ema --model-ema ...

Everything in main.py plus: the progressive stage schedule, per-stage
model / optimizer / loader rebuild with weight remapping, the
elastic-supernet auto-grow search and dynamic gradient-accumulation
scaling. The flags are the port's own `config.py`; the device is
`AUTOPROG_TORCH_DEVICE` (default cuda; see platform.py). `--resume`,
`--finetune` and `--initial-checkpoint` raise NotImplementedError, as in
main.py; the checkpoints do record the stage's arch for a later resume.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List

from autoprog_tpu_torch import engine
from autoprog_tpu_torch.config import parse_args, parse_variant_name
from autoprog_tpu_torch.main import check_ported
from autoprog_tpu_torch.prog import autogrow
from autoprog_tpu_torch.prog.depth import elastic_keep_masks
from autoprog_tpu_torch.prog.schedule import get_divisor, no_repeats, progressive_schedule
from autoprog_tpu_torch.train.checkpoint import CheckpointSaver
from autoprog_tpu_torch.utils.logging import make_output_dir, setup_logging, update_summary
from autoprog_tpu_torch.utils.meters import AverageMeter

_logger = logging.getLogger("autoprog_tpu_torch")

# Canonical VOLO sizes in the name-as-config grammar. Each alias is the
# exact 2-stage collapse of the 4-stage registry model (stages 1-3 share
# dim, heads and resolution, so collapsing them into one transformer stage
# is the identical network). D4 / D5 use the fixed-width families
# (models/factory.py) because their transformer head_dim (48) is outside the
# [h/2, h, h, h] grammar.
_VARIANT_ALIASES = {
    "volo_d1": "volo_h12_l18",
    "volo_d2": "volo_h16_l24",
    "volo_d3": "volo_h16_l36",
    "volo_d4": "volod4_h16_l36",
    "volo_d5": "volod5_h16_l48",
}

# test/debug seam: the last completed run's TrainContext (carries
# `stage_history`, the traversed (epoch, r, h, l, ...) sequence)
LAST_CTX = None


def auto_grow(ctx, *, search_r, search_h, search_l, current_dp, current_aa,
              current_re, current_resize, epoch, stage, loader_eval,
              loader_search, output_dir, best_metric, epoch_time_m,
              splits: int):
    """Supernet search at a stage boundary. Grows ctx into the
    max-candidate supernet, trains it for `--search-epochs` with random
    sub-config sampling, and returns the winning (r, l)."""
    args = ctx.args
    search_r, search_h, search_l = (no_repeats(search_r),
                                    no_repeats(search_h),
                                    no_repeats(search_l))
    assert len(search_h) == 1, "width auto grow is not supported yet"
    assert search_l[-1] <= 2 * search_l[0], \
        "auto grow beyond 2x depth is not supported"
    family = parse_variant_name(ctx.mdef.name)[0]
    supernet_name = f"{family}_h{search_h[-1]}_l{search_l[-1]}"
    engine.create_stage_model_and_state(ctx, supernet_name, dp=current_dp,
                                        load="slice", seed_offset=epoch)
    loader_train = engine.make_train_loader(
        ctx, aa=current_aa, re_prob=current_re, resize=current_resize)
    cfg_strs = [f"r{r}_l{l}" for r in search_r for l in search_l]
    _logger.info("auto grow: r %s l %s -> cfgs %s", list(search_r),
                 list(search_l), cfg_strs)
    l_min, l_max = search_l[0], search_l[-1]
    best_cfg, table = None, {}
    for search_epoch in range(epoch, epoch + args.search_epochs):
        train_metrics, rounds, loss_0, loss_last = \
            autogrow.train_one_epoch_super(
                ctx, search_epoch, loader_train, loader_search,
                r_list=list(search_r), l_list=list(search_l),
                cfg_strs=cfg_strs, splits=splits,
                eval_times=1 if search_epoch == epoch else 4,
                epoch_time_m=epoch_time_m)
        # evaluate the smallest sub-config + EMAs
        keep = elastic_keep_masks(l_min, l_min, l_max,
                                  getattr(ctx.mdef.arch, "family", "volo"))
        eval_metrics, names = engine.evaluate_all(ctx, loader_eval, keep=keep)
        update_summary(search_epoch, train_metrics, eval_metrics,
                       os.path.join(output_dir, "summary.csv"),
                       write_header=best_metric is None)
        save_metric = max(eval_metrics[n] for n in names)
        payload = engine.ckpt_payload(ctx, {
            "r": search_r[-1], "h": search_h[-1], "l": search_l[-1],
            "stage": stage, "dp": current_dp, "supernet": True})
        best_metric, _ = ctx.saver.save_checkpoint(
            payload, search_epoch, metric=save_metric, prefix="-search")
        best_cfg, table = autogrow.score_candidates(rounds, cfg_strs, stage)
    loader_train.close()
    best_r, best_l = autogrow.parse_cfg(best_cfg)
    best_r, best_l = autogrow.sync_decision(best_r, best_l)
    _logger.info("auto grow decision: r=%d l=%d", best_r, best_l)
    return best_r, search_h[-1], best_l, best_metric


def main(argv=None):
    args, args_text = parse_args(argv, prog=True)
    check_ported(args)
    args.model = _VARIANT_ALIASES.get(args.model, args.model)
    output_dir = make_output_dir(args.output, args.model, suffix="prog")
    setup_logging(os.path.join(output_dir, "log.txt"))

    # progressive schedule
    r_max = args.img_size or (args.input_size[-1] if args.input_size
                              else 224)
    family, h_max, l_max = parse_variant_name(args.model)
    sched = progressive_schedule(
        num_stages=args.num_stages, epochs=args.epochs, r_max=r_max,
        h_max=h_max, l_max=l_max, r_scale=args.r_scale,
        h_scale=args.h_scale, l_scale=args.l_scale, aa_scale=args.aa_scale,
        dp_scale=args.dp_scale, re_scale=args.re_scale,
        resize_scale=args.resize_scale, aa_max=args.aa,
        dp_max=args.drop_path or 0.0, re_max=args.reprob,
        resize_max=args.scale)
    _logger.info(
        "Progressive training settings:\n\tstages: %d\n\tgrow epochs: %s\n"
        "\tresolution: %s\n\theads: %s\n\tlayers: %s\n\tRA: %s\n"
        "\tdrop path: %s\n\trandom erase: %s\n\tcrop: %s",
        args.num_stages, sched.grow_epochs, sched.resolutions, sched.heads,
        sched.layers, sched.rand_aug, sched.drop_path, sched.random_erase,
        sched.crop_scale)
    cur = dict(r=sched.resolutions[0], h=sched.heads[0], l=sched.layers[0],
               dp=sched.drop_path[0], aa=sched.rand_aug[0],
               re=sched.random_erase[0], resize=sched.crop_scale[0])
    args.model = f"{family}_h{cur['h']}_l{cur['l']}"

    # must precede setup(): the loss is selected there from
    # token_label_size, and the stale default of 1 would pick the
    # relabel-style loss against dense token maps
    args.token_label_size = cur["r"] // 16
    ctx = engine.setup(args, args_text, prog=True,
                       output_dir=output_dir, initial_model=args.model)

    _logger.info("device: %s", ctx.device)

    # dynamic grad-accum scaling by activation ratio
    original_splits = args.batch_splits_list[-1]
    act_max = l_max * r_max * r_max
    if args.batch_size % original_splits != 0:
        raise SystemExit(f"batch size {args.batch_size} must be divisible by "
                         f"batch splits {original_splits}")

    def splits_for(l, r):
        return get_divisor(original_splits, (l * r * r) / act_max)

    splits = splits_for(cur["l"], cur["r"])

    loader_train = engine.make_train_loader(
        ctx, aa=cur["aa"], re_prob=cur["re"], resize=cur["resize"])
    loader_eval = engine.make_eval_loader(ctx)
    loader_search = engine.make_search_loader(ctx)

    eval_metric = args.eval_metric
    ctx.saver = CheckpointSaver(
        checkpoint_dir=output_dir, decreasing=(eval_metric == "loss"),
        max_history=args.checkpoint_hist)
    with open(os.path.join(output_dir, "args.yaml"), "w") as f:
        f.write(args_text)

    start_epoch = args.start_epoch or 0

    num_epochs = ctx.schedule.num_epochs
    _logger.info("Scheduled epochs: %d", num_epochs)
    epoch_time_m = AverageMeter()
    best_metric = best_epoch = None
    grow_epochs: List[int] = list(sched.grow_epochs)
    stage_history: List[dict] = [dict(epoch=start_epoch, **cur)]
    ctx.stage_history = stage_history
    try:
        for epoch in range(start_epoch, num_epochs):
            if epoch in grow_epochs:
                stage = grow_epochs.index(epoch)
                prev = dict(cur)
                origin_l = prev["l"]
                if args.auto_grow and stage < len(grow_epochs) - 1:
                    search_r, search_h, search_l = autogrow.candidate_window(
                        sched.resolutions, sched.heads, sched.layers,
                        cur["r"], cur["h"], cur["l"], stage)
                    if (cur["r"], cur["h"], cur["l"]) != \
                            (search_r[-1], search_h[-1], search_l[-1]):
                        # auto grow trains the supernet with the *final*
                        # AugReg
                        prev.update(r=search_r[-1], h=search_h[-1],
                                    l=search_l[-1],
                                    dp=sched.drop_path[-1],
                                    aa=sched.rand_aug[-1],
                                    re=sched.random_erase[-1],
                                    resize=sched.crop_scale[-1])
                        best_r, best_h, best_l, best_metric = auto_grow(
                            ctx, search_r=search_r, search_h=search_h,
                            search_l=search_l, current_dp=sched.drop_path[-1],
                            current_aa=sched.rand_aug[-1],
                            current_re=sched.random_erase[-1],
                            current_resize=sched.crop_scale[-1],
                            epoch=epoch, stage=stage,
                            loader_eval=loader_eval,
                            loader_search=loader_search,
                            output_dir=output_dir, best_metric=best_metric,
                            epoch_time_m=epoch_time_m,
                            splits=original_splits)
                        cur.update(r=best_r, h=best_h, l=best_l,
                                   dp=sched.drop_path[stage],
                                   aa=sched.rand_aug[stage],
                                   re=sched.random_erase[stage],
                                   resize=sched.crop_scale[stage])
                else:
                    cur = dict(r=sched.resolutions[stage],
                               h=sched.heads[stage], l=sched.layers[stage],
                               dp=sched.drop_path[stage],
                               aa=sched.rand_aug[stage],
                               re=sched.random_erase[stage],
                               resize=sched.crop_scale[stage])

                if cur["h"] != prev["h"] or cur["l"] != prev["l"] or \
                        cur["dp"] != prev["dp"]:
                    load = "slice" if (cur["h"] >= prev["h"]
                                      and cur["l"] >= prev["l"]) else "super"
                    args.model = f"{family}_h{cur['h']}_l{cur['l']}"
                    engine.create_stage_model_and_state(
                        ctx, args.model, dp=cur["dp"], load=load,
                        origin_l=origin_l, seed_offset=epoch)
                if any(cur[k] != prev[k]
                       for k in ("r", "aa", "re", "resize", "l")):
                    splits = splits_for(cur["l"], cur["r"])
                    args.token_label_size = cur["r"] // 16
                    loader_train = engine.make_train_loader(
                        ctx, aa=cur["aa"], re_prob=cur["re"],
                        resize=cur["resize"])
                if args.recal_bn_steps and (cur["l"] != prev["l"]
                                            or cur["h"] != prev["h"]):
                    from autoprog_tpu_torch.train.bn import recalibrate_bn
                    recalibrate_bn(ctx, loader_train, r=cur["r"],
                                   max_steps=args.recal_bn_steps)
                _logger.info("stage %d: %s (batch splits %d)", stage, cur,
                             splits)
                stage_history.append(dict(epoch=epoch, stage=stage, **cur))

            if args.auto_grow and any(
                    epoch in range(e, e + args.search_epochs)
                    for e in grow_epochs[:-1]):
                # epochs consumed by the supernet search are skipped
                continue

            train_metrics = engine.train_one_epoch(
                ctx, epoch, loader_train, r=cur["r"], splits=splits,
                epoch_time_m=epoch_time_m)
            eval_metrics, names = engine.evaluate_all(ctx, loader_eval)
            if hasattr(ctx.schedule, "observe"):  # plateau schedule
                ctx.schedule.observe(max(eval_metrics[n] for n in names))
            update_summary(epoch, train_metrics, eval_metrics,
                           os.path.join(output_dir, "summary.csv"),
                           write_header=best_metric is None)
            save_metric = max(eval_metrics[n] for n in names)
            payload = engine.ckpt_payload(ctx, dict(cur, stage=sched.stage_at_epoch(epoch)))
            best_metric, best_epoch = ctx.saver.save_checkpoint(
                payload, epoch, metric=save_metric)
    except KeyboardInterrupt:
        pass
    finally:
        loader_train.close()
        loader_eval.close()
        loader_search.close()
    if best_metric is not None:
        _logger.info("*** Best metric: %s (epoch %s)", best_metric,
                     best_epoch)
    _logger.info("total train time: %.1fs", epoch_time_m.sum)
    global LAST_CTX
    LAST_CTX = ctx
    return best_metric


if __name__ == "__main__":
    main(sys.argv[1:])
