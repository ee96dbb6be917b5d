#!/usr/bin/env python
"""A/B of bf16 state storage (EMA trees, optionally Adam's first moment) on
the card, counterpart of the JAX package's `scripts/ab_bf16_state.py`.

Stores the EMA trees (AUTOPROG_BENCH_EMA_BF16=1) and Adam's first moment
(AUTOPROG_BENCH_MU_BF16=1) in bf16, which halves the bytes of those
per-step sweeps over the parameters. Numerics are held by
`tests/test_torch_options.py` (the stochastically rounded EMA bit for bit
against the JAX package's, bf16-mu AdamW).

Runs the port's headline bench (`python -m autoprog_tpu_torch.bench`) three
times, both switches set on each leg:
  f32state          both 0 (the baseline)
  emabf16           EMA trees bf16
  emabf16_mubf16    EMA trees and Adam mu bf16

Each leg writes output/bench_r4_<tag>.json (the bench's JSON line). If the
best bf16 leg beats f32state by >= 1 % img/s, writes
output/bench_autotune.json with the JAX package's keys; otherwise the A/B is
a measured rejection and no verdict file is left (a verdict of an earlier
run is moved aside to bench_autotune.json.stale before the legs, so a stale
win cannot linger). The port's bench does not read that file: a winning
verdict becomes a change of default in a change of its own.

    python -m autoprog_tpu_torch.scripts.ab_bf16_state
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "output")

LEGS = [
    ("f32state", {"AUTOPROG_BENCH_EMA_BF16": "0",
                  "AUTOPROG_BENCH_MU_BF16": "0"}),
    ("emabf16", {"AUTOPROG_BENCH_EMA_BF16": "1",
                 "AUTOPROG_BENCH_MU_BF16": "0"}),
    ("emabf16_mubf16", {"AUTOPROG_BENCH_EMA_BF16": "1",
                        "AUTOPROG_BENCH_MU_BF16": "1"}),
]


def run_bench(tag: str, knobs: dict, leg_file: str, who: str) -> dict | None:
    """One bench run with `knobs` set: its last stdout line goes to
    `leg_file`; its parsed JSON is returned, or None where it failed."""
    env = dict(os.environ)
    env.update(knobs)
    print(f"[{who}] running leg {tag} {knobs}", flush=True)
    proc = subprocess.run(
        [sys.executable, "-m", "autoprog_tpu_torch.bench"],
        cwd=ROOT, env=env, capture_output=True, text=True)
    sys.stderr.write(proc.stderr)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    with open(leg_file, "w") as f:
        f.write(line + "\n")
    if proc.returncode != 0:
        print(f"[{who}] leg {tag} FAILED rc={proc.returncode}: "
              f"{line}", flush=True)
        return None
    res = json.loads(line)
    print(f"[{who}] leg {tag}: {res['value']} img/s "
          f"(vs_baseline {res['vs_baseline']})", flush=True)
    return res


def run_leg(tag: str, knobs: dict) -> dict | None:
    return run_bench(tag, knobs, os.path.join(OUT, f"bench_r4_{tag}.json"),
                     "ab_bf16_state")


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    # move an earlier verdict aside before the legs: a failing leg returns
    # early, and a stale win must not survive it
    stale = os.path.join(OUT, "bench_autotune.json")
    if os.path.exists(stale):
        os.replace(stale, stale + ".stale")
    results = {}
    for tag, knobs in LEGS:
        res = run_leg(tag, knobs)
        if res is None:
            return 1
        results[tag] = res["value"]

    base = results["f32state"]
    best_tag = max(results, key=results.get)
    autotune = os.path.join(OUT, "bench_autotune.json")
    if best_tag != "f32state" and results[best_tag] >= base * 1.01:
        cfg = {"ema_bf16": True,
               "mu_bf16": best_tag == "emabf16_mubf16",
               "legs_img_per_s": results}
        with open(autotune, "w") as f:
            json.dump(cfg, f, indent=1)
        print(f"[ab_bf16_state] WIN: {best_tag} "
              f"{results[best_tag]:.1f} vs f32 {base:.1f} "
              f"(+{100 * (results[best_tag] / base - 1):.2f}%) -> "
              f"bench_autotune.json {cfg}", flush=True)
    else:
        if os.path.exists(autotune):
            os.remove(autotune)
        print(f"[ab_bf16_state] REJECTED: best {best_tag} "
              f"{results[best_tag]:.1f} vs f32 {base:.1f} "
              f"(<1% win); no autotune file", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
