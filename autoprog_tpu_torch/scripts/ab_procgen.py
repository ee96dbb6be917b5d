#!/usr/bin/env python
"""Accuracy A/B on the procgen benchmark (`data/procgen.py`: deterministic
shape-composition classification), counterpart of the JAX package's
`scripts/ab_procgen.py`.

The protocol of `real_data_digits.py`: the same model, data and epoch budget
trained (a) at full size with `autoprog_tpu_torch.main` and (b)
progressively with AutoProg with `autoprog_tpu_torch.main_prog`, both in
this process; the table compares best held-out top-1 and the train loops'
seconds, averaged over seeds (top-1 at equal epochs, not time to accuracy).

An arm whose log already holds its result is reused, not trained again;
`--deadline-ts` starts no new arm past that time; `--summarize-only` trains
nothing and prints the table of the completed pairs under `--root`. The
exit code is 4 when no seed pair has completed.

    python -m autoprog_tpu_torch.scripts.ab_procgen      # on the card
    AUTOPROG_TORCH_DEVICE=cpu python -m autoprog_tpu_torch.scripts.ab_procgen \\
        --epochs 4 --train-size 512 --num-classes 10 --img-size 64 -b 32
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time

from autoprog_tpu_torch.scripts.real_data_digits import _train_time, card_flags


def common_flags(a, seed: int) -> list:
    return [
        "--num-classes", str(a.num_classes), "--img-size", str(a.img_size),
        "-b", str(a.batch), "--fake-data-size", str(a.train_size),
        "--lr", "1e-3", "--warmup-epochs", "2", "--cooldown-epochs", "0",
        "--sched", "cosine", "--min-lr", "1e-5", "--weight-decay", "0.05",
        "--scale", "0.6", "1.0", "--workers", str(a.workers),
        "--seed", str(seed), "--smoothing", "0.1", "--drop-path", "0.1",
        "--aa", "rand-m9-mstd0.5-inc1", "--remode", "pixel", "--reprob",
        "0.25",
        "--model-ema", "--model-ema-decay", "0.9", "0.95", "0.99", "0.995",
    ] + card_flags()


def _completed_result(out: str):
    """(best_top1, train_s) of an earlier finished run in `out`, else None.

    Both trainers log '*** Best metric:' and then 'total train time:' only
    after the last epoch, so a log with both lines is a finished arm, and
    the values are what run_fixed / run_autoprog would have returned. A run
    killed part way lacks them and is run again."""
    logs = sorted(glob.glob(os.path.join(out, "train", "*", "log.txt")))
    if not logs:
        return None
    with open(logs[-1]) as f:
        text = f.read()
    best = re.findall(r"\*\*\* Best metric: ([0-9.]+)", text)
    tsec = re.findall(r"total train time: ([0-9.]+)s", text)
    if not best or not tsec:
        return None
    return float(best[-1]), float(tsec[-1])


def run_fixed(a, out: str, seed: int):
    from autoprog_tpu_torch.main import main
    best = main(["procgen://", "--model", a.model,
                 "--epochs", str(a.epochs), "--output", out]
                + common_flags(a, seed))
    return best, _train_time(out)


def run_autoprog(a, out: str, seed: int):
    from autoprog_tpu_torch.main_prog import main
    best = main(["procgen://", "--model", a.model,
                 "--epochs", str(a.epochs), "--output", out,
                 "--num-stages", str(a.stages), "--r-scale", "0.5",
                 "--l-scale", "0.5", "--auto-grow",
                 "--search-epochs", "1", "--search-probe-steps", "2",
                 "--load-with-clone-ema"] + common_flags(a, seed))
    return best, _train_time(out)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--model", default="volo_h4_l8")
    p.add_argument("--num-classes", type=int, default=100)
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--train-size", type=int, default=16000,
                   help="val split is train_size // 4 (engine.py)")
    p.add_argument("-b", "--batch", type=int, default=128)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--stages", type=int, default=3)
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 7, 123])
    p.add_argument("--root", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "output", "procgen_runs"))
    p.add_argument("--deadline-ts", type=float, default=0.0,
                   help="unix timestamp: start no new arm past it (a running "
                        "arm finishes; completed pairs are summarized; arms "
                        "completed by earlier attempts are reused)")
    p.add_argument("--summarize-only", action="store_true",
                   help="no training: parse the completed arm pairs under "
                        "--root and print the summary table")
    a = p.parse_args()

    rows = []
    stopped = False
    for seed in a.seeds:
        if stopped:
            break
        t0 = time.perf_counter()
        pair = []
        for label, runner in (("fixed", run_fixed),
                              ("autoprog", run_autoprog)):
            out = os.path.join(a.root, f"{label}_s{seed}")
            prior = _completed_result(out)
            if prior is not None:
                print(f"[reuse] {label} s{seed}: top1 {prior[0]:.2f} "
                      f"({prior[1]:.0f}s) from a prior completed run",
                      flush=True)
                pair.append(prior)
                continue
            if a.summarize_only:
                print(f"[summarize-only] {label} s{seed}: no completed "
                      "run; pair skipped", flush=True)
                break
            if a.deadline_ts and time.time() > a.deadline_ts:
                print(f"[deadline] stopping before {label} s{seed}: past "
                      f"--deadline-ts; {len(rows)} completed pair(s) "
                      "summarized", flush=True)
                stopped = True
                break
            pair.append(runner(a, out, seed))
        if len(pair) != 2:
            continue
        (fixed_top1, fixed_tr), (auto_top1, auto_tr) = pair
        rows.append((seed, fixed_top1, fixed_tr, auto_top1, auto_tr))
        print(f"[seed {seed}] fixed {fixed_top1:.2f} ({fixed_tr:.0f}s)  "
              f"autoprog {auto_top1:.2f} ({auto_tr:.0f}s)  "
              f"delta {auto_top1 - fixed_top1:+.2f}  "
              f"speedup {fixed_tr / max(auto_tr, 1e-9):.2f}x  "
              f"[pair wall {time.perf_counter() - t0:.0f}s]", flush=True)

    if not rows:
        # nonzero: a run that completed no pair is no evidence
        print("no completed seed pairs"
              + ("" if a.summarize_only
                 else " (deadline hit before the first)"))
        sys.exit(4)
    import numpy as np
    f = np.array([r[1] for r in rows], float)
    au = np.array([r[3] for r in rows], float)
    ft = np.array([r[2] for r in rows], float)
    at = np.array([r[4] for r in rows], float)
    print()
    print(f"model={a.model} epochs={a.epochs} seeds={a.seeds} "
          f"(procgen: {a.num_classes} classes, {a.train_size} train / "
          f"{a.train_size // 4} val @ {a.img_size}px)")
    print(f"{'run':<12s} {'top-1 mean+/-std':>18s} {'train s':>9s}")
    print(f"{'fixed':<12s} {f.mean():>9.2f} +/-{f.std():<5.2f} "
          f"{ft.mean():>9.1f}")
    print(f"{'autoprog':<12s} {au.mean():>9.2f} +/-{au.std():<5.2f} "
          f"{at.mean():>9.1f}")
    print(f"train-time speedup {ft.mean() / at.mean():.2f}x, "
          f"top-1 delta {au.mean() - f.mean():+.2f} "
          f"(per-seed deltas: {[round(x, 2) for x in (au - f).tolist()]})")


if __name__ == "__main__":
    main()
