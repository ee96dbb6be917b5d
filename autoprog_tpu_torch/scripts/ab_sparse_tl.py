#!/usr/bin/env python
"""A/B of sparse token-label targets (AUTOPROG_SPARSE_TL) on the card,
counterpart of the JAX package's `scripts/ab_sparse_tl.py`.

The dense path builds a [B, C, 2 + N] f32 target through two full-C
bilinear resizes, only for the cross-entropy to contract it against the
log-probabilities; the sparse path gathers K' log-probabilities per token
from the top-K store instead (`data/token_label.py`, `losses.py`). Both give
the same loss by algebra (`tests/test_torch_options.py`; on the card,
`chip_smoke.py` phase 10).

Runs the port's headline bench (`python -m autoprog_tpu_torch.bench`)
twice:
  densetl   AUTOPROG_SPARSE_TL=0 (the default)
  sparsetl  AUTOPROG_SPARSE_TL=1

Each leg writes output/bench_r5_<tag>.json. A >= 1 % win is the bar for
making sparse the default; otherwise this is a measured rejection. The
verdict goes into output/bench_autotune.json under `sparse_tl`, merged into
what the file already holds (`ab_bf16_state.py`'s verdict stays). The
port's bench does not read that file.

    python -m autoprog_tpu_torch.scripts.ab_sparse_tl
"""

from __future__ import annotations

import json
import os
import sys

from autoprog_tpu_torch.scripts.ab_bf16_state import ROOT, run_bench

OUT = os.path.join(ROOT, "output")

LEGS = [
    ("densetl", {"AUTOPROG_SPARSE_TL": "0"}),
    ("sparsetl", {"AUTOPROG_SPARSE_TL": "1"}),
]


def run_leg(tag: str, knobs: dict) -> dict | None:
    return run_bench(tag, knobs, os.path.join(OUT, f"bench_r5_{tag}.json"),
                     "ab_sparse_tl")


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    results = {}
    for tag, knobs in LEGS:
        res = run_leg(tag, knobs)
        if res is None:
            return 1
        results[tag] = res["value"]
    base, sparse = results["densetl"], results["sparsetl"]
    rel = sparse / base - 1.0
    win = rel >= 0.01
    verdict = "WIN — promote sparse as default" if win else \
        "REJECTED (<1% or regression) — keep dense default"
    print(f"[ab_sparse_tl] dense {base:.1f} vs sparse {sparse:.1f} img/s "
          f"({rel * 100:+.2f}%): {verdict}", flush=True)
    autotune = os.path.join(OUT, "bench_autotune.json")
    tuned = {}
    if os.path.exists(autotune):
        try:
            with open(autotune) as f:
                tuned = json.load(f)
        except (ValueError, OSError):
            tuned = {}
    tuned["sparse_tl"] = bool(win)
    with open(autotune, "w") as f:
        json.dump(tuned, f)
    print(f"[ab_sparse_tl] bench_autotune.json <- {tuned}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
