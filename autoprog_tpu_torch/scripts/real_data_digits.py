#!/usr/bin/env python
"""Real-data accuracy A/B: AutoProg against fixed training on real
handwritten digit scans, counterpart of the JAX package's
`scripts/real_data_digits.py`.

The data are the 1,797 8x8 scans of UCI's "Optical Recognition of
Handwritten Digits" (CC BY 4.0), 10 classes, in the form scikit-learn 1.9.0
ships them (`sklearn/datasets/data/digits.csv.gz`, BSD-3): a copy of that
file, byte for byte, is `autoprog_tpu_torch/data/digits.csv.gz`, read here
as `sklearn.datasets.load_digits` reads it (scikit-learn is not needed).

The same model and epoch budget train (a) at full size with
`autoprog_tpu_torch.main` and (b) progressively with AutoProg with
`autoprog_tpu_torch.main_prog`, both in this process; the table compares
best top-1 on a held-out split and the train loops' seconds, per seed and
as mean +/- std. This is top-1 at equal epochs, not time to accuracy.

    python -m autoprog_tpu_torch.scripts.real_data_digits [--epochs N] [--seeds 42 7 123]
    AUTOPROG_TORCH_DEVICE=cpu python -m autoprog_tpu_torch.scripts.real_data_digits --epochs 2

Writes the ImageFolder tree under output/digits_data/ and the runs under
output/digits_runs/ (both under `--root`).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import os
import re
import shutil
import time

import numpy as np

DIGITS = os.path.join(os.path.dirname(__file__), "..", "data", "digits.csv.gz")


def load_digits():
    """(images [1797, 8, 8] float64 in 0..16, target [1797] int), as
    `sklearn.datasets.load_digits()` returns them."""
    with gzip.open(DIGITS, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def materialize(root: str) -> None:
    """The digits as an ImageFolder tree: 64 px RGB PNGs (nearest-neighbour),
    a stratified 80/20 train / val split."""
    from PIL import Image

    if os.path.exists(os.path.join(root, "DONE")):
        return
    shutil.rmtree(root, ignore_errors=True)
    images, labels = load_digits()
    counters = {}
    for i, (im, y) in enumerate(zip(images, labels)):
        k = counters.get(int(y), 0)
        counters[int(y)] = k + 1
        split = "val" if k % 5 == 4 else "train"
        cls_dir = os.path.join(root, split, str(int(y)))
        os.makedirs(cls_dir, exist_ok=True)
        arr = np.clip(im * 255.0 / 16.0, 0, 255).astype(np.uint8)
        png = Image.fromarray(arr).convert("RGB").resize((64, 64), Image.NEAREST)
        png.save(os.path.join(cls_dir, f"{i}.png"))
    open(os.path.join(root, "DONE"), "w").close()


def card_flags() -> list:
    """`--no-bf16` on the CPU, `--uint8-pipe` on the card (uint8 batches to
    the device, normalised in the step), by the port's device setting."""
    from autoprog_tpu_torch.platform import default_device
    return ["--no-bf16"] if default_device().type == "cpu" else ["--uint8-pipe"]


def common_flags(seed: int = 42) -> list:
    """One training configuration for both arms, the recipe's 4-decay EMA
    list included (the fixed baseline uses EMA too)."""
    return [
        "--num-classes", "10", "--img-size", "64", "-b", "64",
        "--lr", "1e-3", "--warmup-epochs", "1", "--cooldown-epochs", "0",
        "--sched", "cosine", "--min-lr", "1e-5", "--weight-decay", "0.05",
        "--scale", "0.6", "1.0", "--workers", "2", "--seed", str(seed),
        "--smoothing", "0.1",
        "--model-ema", "--model-ema-decay", "0.9", "0.95", "0.99", "0.995",
    ] + card_flags()


def _train_time(out: str) -> float:
    """The run's summed train-epoch seconds from its log (`total train
    time`: no eval, no checkpointing)."""
    logs = sorted(glob.glob(os.path.join(out, "train", "*", "log.txt")))
    if not logs:
        return float("nan")
    with open(logs[-1]) as f:
        m = re.findall(r"total train time: ([0-9.]+)s", f.read())
    return float(m[-1]) if m else float("nan")


def run_fixed(data: str, out: str, model: str, epochs: int, seed: int):
    from autoprog_tpu_torch.main import main
    t0 = time.perf_counter()
    best = main([data, "--model", model, "--epochs", str(epochs),
                 "--output", out] + common_flags(seed))
    return best, time.perf_counter() - t0, _train_time(out)


def run_autoprog(data: str, out: str, model: str, epochs: int, seed: int):
    from autoprog_tpu_torch.main_prog import main
    t0 = time.perf_counter()
    best = main([data, "--model", model, "--epochs", str(epochs),
                 "--output", out,
                 "--num-stages", "2", "--r-scale", "0.5",
                 "--l-scale", "0.5", "--auto-grow",
                 "--search-epochs", "1", "--search-probe-steps", "2",
                 "--load-with-clone-ema"] + common_flags(seed))
    return best, time.perf_counter() - t0, _train_time(out)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--model", default="volo_h2_l4")
    p.add_argument("--seeds", type=int, nargs="+", default=[42],
                   help="one full fixed-vs-autoprog A/B per seed; the "
                        "summary reports mean +/- std over seeds")
    p.add_argument("--root", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "output"))
    args = p.parse_args()

    data = os.path.join(args.root, "digits_data")
    runs = os.path.join(args.root, "digits_runs")
    materialize(data)

    rows = []
    for seed in args.seeds:
        fixed_top1, fixed_s, fixed_tr = run_fixed(
            data, os.path.join(runs, f"fixed_s{seed}"), args.model,
            args.epochs, seed)
        auto_top1, auto_s, auto_tr = run_autoprog(
            data, os.path.join(runs, f"autoprog_s{seed}"), args.model,
            args.epochs, seed)
        rows.append((seed, fixed_top1, fixed_tr, auto_top1, auto_tr))
        print(f"[seed {seed}] fixed {fixed_top1:.2f} ({fixed_tr:.0f}s)  "
              f"autoprog {auto_top1:.2f} ({auto_tr:.0f}s)  "
              f"delta {auto_top1 - fixed_top1:+.2f}  "
              f"speedup {fixed_tr / max(auto_tr, 1e-9):.2f}x", flush=True)

    f = np.array([r[1] for r in rows])
    a = np.array([r[3] for r in rows])
    ft = np.array([r[2] for r in rows])
    at = np.array([r[4] for r in rows])
    print()
    n_train, n_val = (len(glob.glob(os.path.join(data, split, "*", "*.png")))
                      for split in ("train", "val"))
    print(f"model={args.model} epochs={args.epochs} seeds={args.seeds} "
          f"(real data: sklearn digits, {n_train} train / {n_val} val)")
    print(f"{'run':<12s} {'top-1 mean+/-std':>18s} {'train s':>9s}")
    print(f"{'fixed':<12s} {f.mean():>9.2f} +/-{f.std():<5.2f} "
          f"{ft.mean():>9.1f}")
    print(f"{'autoprog':<12s} {a.mean():>9.2f} +/-{a.std():<5.2f} "
          f"{at.mean():>9.1f}")
    print(f"train-time speedup {ft.mean() / at.mean():.2f}x, "
          f"top-1 delta {a.mean() - f.mean():+.2f} "
          f"(per-seed deltas: {[round(x, 2) for x in (a - f).tolist()]})")


if __name__ == "__main__":
    main()
