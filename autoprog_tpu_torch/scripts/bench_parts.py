"""Where the volo_d1 train step's time goes, counterpart of the JAX package's
`scripts/bench_parts.py`.

    python -m autoprog_tpu_torch.scripts.bench_parts [batch] [--loss-bisect]

The full step of `bench.py` (volo_h12_l18 at 224 px, bf16, token labels,
MixToken, AdamW, 4 EMA decays; the knobs of `bench.py` apply) is timed
whole and with parts of the model skipped by the elastic keep-mask:
without the 4 outlookers, without the 14 transformer blocks, and with
neither (stem, post-network, heads, loss and optimizer only). Beside them:
the optimizer and the 4 EMA sweeps alone, the eval step and the model's
eval forward alone, and with `--loss-bisect` the full and the stripped step
of a cls-only model (no aux head, no MixToken, soft-target CE), which
isolates the dense token-label loss. The derived segments are the full
step less the step without the outlookers (the outlooker segment), less
the step without the transformers (the transformer segment), and the
stripped step (the rest).

Times: CUDA events around `iters` chained calls after warm-up
(`scripts/timing.py`). The table goes to stderr; stdout carries one JSON
line with the rows, the derived segments, the batch and the card's name and
power limit. On the CPU (AUTOPROG_TORCH_DEVICE=cpu, for the tests) it runs
one call per row at batch 2 by default; such times say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import torch

#: the segments, each a row less another (None: the row alone)
SEGMENTS = {"outlooker segment": ("full step", "no outlookers"),
            "transformer segment": ("full step", "no transformers"),
            "rest (stem, post, heads, loss, optimizer, EMA)": ("stem+post+heads+opt only", None)}


def keep_masks(model) -> Dict[str, object]:
    """The step's rows by keep mask: the full step, without the outlookers,
    without the transformer blocks, and with neither (the stripped step)."""
    L0, L1 = model.layers[0], model.layers[1]
    return {"full step": None, "no outlookers": ((False,) * L0, (True,) * L1),
            "no transformers": ((True,) * L0, (False,) * L1),
            "stem+post+heads+opt only": ((False,) * L0, (False,) * L1)}


def derive(values: Dict[str, float]) -> Dict[str, float]:
    """The segments of `SEGMENTS` from one value per row (ms, FLOP, ...)."""
    return {name: values[hi] - (values[lo] if lo else 0.0)
            for name, (hi, lo) in SEGMENTS.items()}


def _cls_only_step(device, batch: int):
    """The step of a cls-only volo_d1: no aux head, no MixToken, soft-target
    CE on smoothed one-hot rows."""
    from autoprog_tpu_torch import bench
    from autoprog_tpu_torch.losses import build_train_loss
    from autoprog_tpu_torch.registry import create_model
    from autoprog_tpu_torch.train.optim import create_optimizer
    from autoprog_tpu_torch.train.state import TrainState
    from autoprog_tpu_torch.train.steps import StepBuilder
    args = argparse.Namespace(opt="adamw", opt_eps=None, opt_betas=None, momentum=0.9,
                              weight_decay=0.05, token_label=False, smoothing=0.1)
    torch.manual_seed(0)
    model = create_model(bench.MODEL).make(
        num_classes=bench.NUM_CLASSES, img_size=bench.IMG_SIZE, dtype=torch.bfloat16,
        return_dense=False, mix_token=False).to(device)
    state = TrainState.create(model=model, optimizer=create_optimizer(args, model),
                              ema_decays=bench.EMA_DECAYS)
    sb = StepBuilder(train_loss=build_train_loss(args), ema_decays=bench.EMA_DECAYS,
                     num_classes=bench.NUM_CLASSES, device=device, seed=0)
    return sb, state


def main(argv=None) -> Dict:
    from autoprog_tpu_torch import bench
    from autoprog_tpu_torch.platform import default_device
    from autoprog_tpu_torch.scripts.timing import card_name, time_call

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=None)
    p.add_argument("--loss-bisect", action="store_true")
    opts = p.parse_args(argv)
    device = default_device()
    on_card = device.type == "cuda"
    batch = opts.batch or (128 if on_card else 2)
    iters, warmup = (20, 3) if on_card else (1, 0)
    sb, state, data = bench.make_step(device, batch)
    lr, r = 1.6e-3, bench.IMG_SIZE
    masks = keep_masks(state.model)
    rows: Dict[str, float] = {}

    def report(name, fn):
        rows[name] = time_call(fn, iters, warmup, device)
        print(f"{name:<34s} {rows[name]:8.3f} ms  {batch / rows[name] * 1e3:7.0f} img/s",
              file=sys.stderr)

    def train(sb_, state_, keep):
        return lambda: sb_.train_step(state_, data, lr, r=r, keep=keep)

    for name, keep in masks.items():
        report(name, train(sb, state, keep))
    stripped = masks["stem+post+heads+opt only"]
    if opts.loss_bisect:
        sb_cls, state_cls = _cls_only_step(device, batch)
        report("cls-only full step", train(sb_cls, state_cls, None))
        report("cls-only stem+post+heads+opt", train(sb_cls, state_cls, stripped))
        del sb_cls, state_cls

    # the optimizer and the EMA sweeps alone, on gradients equal to the
    # parameters
    params = [p.detach() for p in state.model.parameters()]
    for p in state.model.parameters():
        p.grad = p.detach().clone()

    def opt_only():
        state.optimizer.step()
        sb._update_ema(state, params)
    report("optimizer+4xEMA only", opt_only)
    state.optimizer.zero_grad(set_to_none=True)

    report("eval fwd (full)", lambda: sb.eval_step(state, data))
    with torch.no_grad():
        report("model fwd only", lambda: state.model(data["image"], train=False))

    derived = derive(rows)
    print("derived:", file=sys.stderr)
    for name, ms in derived.items():
        print(f"  {name}: {ms:.3f} ms", file=sys.stderr)
    result = {"metric": "volo_d1_train_step_segments_ms", "batch": batch, "img_size": r,
              "card": card_name(device), "rows": rows, "derived": derived}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
