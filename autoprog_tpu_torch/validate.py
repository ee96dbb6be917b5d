"""Standalone checkpoint evaluator of the port, counterpart of
`autoprog_tpu/validate.py`.

    python -m autoprog_tpu_torch.validate synthetic:// --checkpoint run/model_best.ckpt

Single or bulk evaluation (a directory, a wildcard or `--model all`) of
either package's checkpoints: top-1 / top-5 / loss, the EMA tree of
`--ema-idx` with `--use-ema`, `--test-pool`, `--tta`, `--real-labels`, a
CSV of results and batch halving on `torch.cuda.OutOfMemoryError`. The
arch is the checkpoint's, and its dense aux head is built where the
checkpoint has one. Without `--tta` and `--real-labels` each batch goes
through the trainer's own `StepBuilder.eval_step` and the sums are taken in
the trainer's order, so on the same checkpoint and samples the metrics
equal the trainer's eval row exactly. The device is `AUTOPROG_TORCH_DEVICE`
(default cuda; see platform.py).

Under torchrun (`torchrun --nproc_per_node N -m autoprog_tpu_torch.validate
...`) the ranks split the eval set as the trainers' eval loader does: rank r
takes samples r, r + N, ..., `-b // N` a batch, the last batch padded with
rows of label -1 that no sum counts (`data/loader.py:pad_eval_batch`). The
four metric sums are summed over the ranks at the end, so top-1 / top-5
equal one process's exactly and the loss to the order of its f32 sums; rank
0 alone logs the result and writes the CSV. The validator is data parallel
only, as the JAX one (no `--model-parallel`). `--real-labels`, which looks
samples up by their place in the whole set, runs in one process only.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import logging
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from autoprog_tpu_torch.config import resolve_data_config
from autoprog_tpu_torch.data.dataset import create_dataset
from autoprog_tpu_torch.data.loader import create_loader, pad_eval_batch
from autoprog_tpu_torch.engine import to_device
from autoprog_tpu_torch.parallel import mesh
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.registry import create_model, list_models
from autoprog_tpu_torch.train.checkpoint import load_checkpoint_file
from autoprog_tpu_torch.train.state import TrainState
from autoprog_tpu_torch.train.steps import StepBuilder
from autoprog_tpu_torch.utils.logging import setup_logging

_logger = logging.getLogger("autoprog_tpu_torch.validate")


def build_parser():
    p = argparse.ArgumentParser(description="autoprog_tpu_torch validation")
    p.add_argument("data_dir", metavar="DIR", nargs="?", default="synthetic://")
    p.add_argument("--dataset", "-d", default="")
    p.add_argument("--split", default="validation")
    p.add_argument("--model", default="volo_d1")
    p.add_argument("--checkpoint", default="")
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--crop-pct", type=float, default=None)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--interpolation", default="", type=str)
    p.add_argument("--mean", type=float, nargs="+", default=None)
    p.add_argument("--std", type=float, nargs="+", default=None)
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--ema-idx", type=int, default=None)
    p.add_argument("--workers", "-j", type=int, default=4)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--results-file", default="")
    p.add_argument("--no-bf16", action="store_true", default=False)
    p.add_argument("--test-pool", action="store_true", default=False,
                   help="fuse the mean-pooled dense class logits instead of the max "
                        "(no-op for a model without a dense aux head)")
    p.add_argument("--tta", type=int, default=0,
                   help="average the logits over groups of N adjacent views of a sample")
    p.add_argument("--real-labels", default="", type=str, metavar="JSON",
                   help="ImageNet-Real relabeled eval: JSON mapping the val images to "
                        "acceptable label sets")
    p.add_argument("--fake-data-size", type=int, default=256)
    p.add_argument("--input-size", default=None, nargs=3, type=int)
    return p


def _params_key(ckpt, use_ema: bool, ema_idx: Optional[int]) -> str:
    if use_ema:
        if ema_idx is not None and f"state_dict_ema_{ema_idx}" in ckpt:
            return f"state_dict_ema_{ema_idx}"
        if "state_dict_ema_0" in ckpt:
            return "state_dict_ema_0"
        _logger.info("no EMA weights found, using online weights")
    return "state_dict"


def validate(args) -> dict:
    device = default_device()
    model_name = args.model
    ckpt = None
    if args.checkpoint:
        ckpt = load_checkpoint_file(args.checkpoint)
        model_name = ckpt.get("arch", model_name)
    mdef = create_model(model_name)
    data_config = resolve_data_config(args, mdef.default_cfg)
    img = args.img_size or data_config["input_size"][-1]
    # a VOLO trained without token labels has no aux head (the trainer
    # builds return_dense=args.token_label): build what the checkpoint holds
    return_dense = None
    if ckpt is not None:
        return_dense = any(k.startswith("aux_head.") for k in ckpt["state_dict"])
    torch.manual_seed(0)
    model = mdef.make(num_classes=args.num_classes, img_size=img,
                      dtype=torch.float32 if args.no_bf16 else torch.bfloat16,
                      return_dense=return_dense,
                      aux_fusion="mean" if args.test_pool else "max")
    if args.test_pool and not getattr(model, "return_dense", False):
        _logger.info("--test-pool: model has no dense aux head; ignored")
    # an EMA tree replaces the parameters per call, as in the trainer's eval
    # (a tree loaded into the model instead can round differently: tensors
    # that require grad may take another kernel)
    ema = None
    if ckpt is not None:
        model.load_state_dict({**ckpt["state_dict"], **(ckpt.get("batch_stats") or {})})
        key = _params_key(ckpt, args.use_ema, args.ema_idx)
        if key != "state_dict":
            ema = {n: t.to(device) for n, t in ckpt[key].items()}
        del ckpt
    state = TrainState(step=0, model=model.to(device), optimizer=None, ema_params=())
    sb = StepBuilder(train_loss=None, num_classes=args.num_classes, device=device)

    ds = create_dataset(args.dataset, args.data_dir, split=args.split, is_training=False,
                        num_classes=args.num_classes, fake_size=args.fake_data_size,
                        image_size=img)
    tta = max(int(args.tta or 0), 1)
    use_preds = tta > 1 or bool(args.real_labels)
    # a batch holds whole TTA groups, on every retry too; `-b` is global
    per_rank = max(args.batch_size // mesh.data_count(), 1)
    batch_size = max(tta, (per_rank // tta) * tta)
    while True:
        loader = create_loader(
            ds, input_size=img, batch_size=batch_size, is_training=False,
            crop_pct=args.crop_pct or data_config["crop_pct"],
            interpolation=data_config["interpolation"], mean=data_config["mean"],
            std=data_config["std"], num_workers=args.workers, tta=tta,
            process_index=mesh.data_index(), process_count=mesh.data_count())
        real = _RealLabels(args.real_labels, ds) if args.real_labels else None
        try:
            acc, src_idx = None, 0
            for i, batch in enumerate(loader):
                n_groups = int(batch["label"].shape[0]) // tta
                batch = to_device(pad_eval_batch(batch, loader.batch_size), device)
                if use_preds:
                    m, preds = sb.logits_eval_step(state, batch, tta=tta, params=ema)
                    if real is not None:
                        real.add_preds(src_idx, preds[:n_groups].cpu().numpy())
                else:
                    m = sb.eval_step(state, batch, params=ema)
                src_idx += n_groups
                # summed on the device in the trainer's order, read at the end
                acc = m if acc is None else {k: acc[k] + m[k] for k in acc}
                if i % args.log_interval == 0:
                    _logger.info("Test: [%4d/%d]  Acc@1 %.4f", i, len(loader),
                                 100 * float(acc["top1_sum"]) / max(float(acc["count"]), 1))
            keys = ("loss_sum", "top1_sum", "top5_sum", "count")
            if acc is None:
                acc = {k: torch.zeros((), device=device) for k in keys}
            if mesh.process_group_active():
                acc = dict(zip(keys, mesh.all_reduce_sum([acc[k] for k in keys])))
            sums = {k: float(v) for k, v in acc.items()}
            break
        except torch.cuda.OutOfMemoryError:
            if batch_size <= tta:
                raise
            batch_size = max(tta, ((batch_size // 2) // tta) * tta)
            torch.cuda.empty_cache()
            _logger.warning("out of memory: retrying with batch size %d", batch_size)
        finally:
            loader.close()
    n = max(sums["count"], 1.0)
    # the trainer's formulas (engine.evaluate), unrounded
    result = {"model": model_name, "checkpoint": args.checkpoint,
              "top1": 100.0 * sums["top1_sum"] / n, "top5": 100.0 * sums["top5_sum"] / n,
              "loss": sums["loss_sum"] / n, "img_size": img,
              "crop_pct": args.crop_pct or data_config["crop_pct"], "count": int(n)}
    if real is not None:
        # a list-form mapping applied by position (no file name matched) is
        # reported under its own key
        result["top1_real_positional" if real.positional else "top1_real"] = real.top1
    _logger.info("Result: %s", result)
    return result


class _RealLabels:
    """ImageNet-Real relabeled accuracy. The acceptable label sets are
    looked up by each sample's file name, in the dataset's own order. Both
    JSON forms: {basename: [labels]} or the original real.json list (the
    order of ILSVRC2012_val_%08d.JPEG). A list against a folder whose names
    match none of those is applied by position, and said so. Samples with an
    empty set are left out."""

    def __init__(self, json_path: str, dataset):
        self.positional = False
        with open(json_path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            by_name = data
        else:
            by_name = {f"ILSVRC2012_val_{i + 1:08d}.JPEG": s for i, s in enumerate(data)}
        names = [os.path.basename(p) for p, _ in getattr(dataset, "samples", [])]
        if names:
            self.sets = [by_name.get(nm) or [] for nm in names]
            if isinstance(data, list) and not any(self.sets):
                _logger.warning("--real-labels: no dataset filename matched the list-form "
                                "JSON; applying labels positionally")
                self.sets = data
                self.positional = True
        elif isinstance(data, list):
            self.sets = data          # no file names (synthetic, iterable): by order
        else:
            self.sets = []
        self.correct = 0
        self.total = 0

    def add_preds(self, start_idx: int, preds) -> None:
        for j, p in enumerate(np.asarray(preds)):
            idx = start_idx + j
            if idx >= len(self.sets) or not self.sets[idx]:
                continue
            self.total += 1
            self.correct += int(p in self.sets[idx])

    @property
    def top1(self) -> float:
        return 100.0 * self.correct / max(self.total, 1)


def write_results(results_file: str, results: List[dict]) -> None:
    with open(results_file, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        w.writeheader()
        for r in results:
            w.writerow(r)


def main(argv=None):
    args = build_parser().parse_args(argv)
    owns_group = not mesh.process_group_active()
    try:
        mesh.maybe_init_distributed()
        if args.real_labels and mesh.process_count() > 1:
            raise NotImplementedError("--real-labels looks samples up by their place in the "
                                      "whole eval set: run it in one process")
        setup_logging(level=logging.INFO if mesh.is_primary() else logging.WARNING)
        return _main(args)
    finally:
        if owns_group:
            mesh.destroy()


def _main(args):
    checkpoints: List[str] = []
    if args.checkpoint and os.path.isdir(args.checkpoint):
        checkpoints = sorted(glob.glob(os.path.join(args.checkpoint, "*.ckpt")))
    elif "*" in args.checkpoint:
        checkpoints = sorted(glob.glob(args.checkpoint))
    results = []
    if args.model == "all":
        # every registered model, each with the first checkpoint of its arch
        ckpt_by_arch = {}
        for c in checkpoints:
            try:
                arch = load_checkpoint_file(c).get("arch")
            except Exception:
                continue
            ckpt_by_arch.setdefault(arch, c)
        for name in list_models():
            if name == "model_variant":
                continue
            sub = argparse.Namespace(**vars(args))
            sub.model, sub.checkpoint = name, ckpt_by_arch.get(name, "")
            try:
                results.append(validate(sub))
            except Exception as e:          # keep sweeping
                _logger.warning("model %s failed: %s", name, e)
        results.sort(key=lambda r: r["top1"], reverse=True)
    elif checkpoints:
        for c in checkpoints:
            sub = argparse.Namespace(**vars(args))
            sub.checkpoint = c
            results.append(validate(sub))
        results.sort(key=lambda r: r["top1"], reverse=True)
    else:
        results.append(validate(args))
    if args.results_file and results and mesh.is_primary():
        write_results(args.results_file, results)
    if results and mesh.is_primary():
        print(f"--result\n{results[0]}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
