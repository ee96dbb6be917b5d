#!/usr/bin/env python
"""A/B of the search loop's host reads on the card, counterpart of the JAX
package's `scripts/ab_search_sync.py`.

Runs the same small AutoProg search three times, each a
`python -m autoprog_tpu_torch.main_prog` process of its own:
  1. warm-up (the default loop): builds or loads the kernel libraries and
     warms the allocator and the host's file cache, so that the two timed
     runs below start alike (there is no compile cache to fill);
  2. AUTOPROG_SYNC_SEARCH=1: each probe step's loss and each supernet
     step's loss read to the host as it comes (`prog/autogrow.py`);
  3. the default: losses summed on the device, one read per probe and per
     log interval.

Reports the per-probe wall time (the median gap between consecutive
"probe r... loss probe" log lines; the probe batches sit on the device, so
this isolates the reads from the host's input feeding) and the search
phase's seconds (first probe to the decision). The children's output goes
to this process's streams; the runs land under output/ab_search_sync/.

    python -m autoprog_tpu_torch.scripts.ab_search_sync
    AUTOPROG_TORCH_DEVICE=cpu python -m autoprog_tpu_torch.scripts.ab_search_sync \\
        --fake-data-size 256 --search-probe-steps 2

`--fake-data-size` and `--search-probe-steps` (2048 and 50, the JAX
script's) only cut the run to a smaller size.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import re
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def run(tag: str, out: str, sync: bool, fake_data_size: int = 2048,
        probe_steps: int = 50) -> str:
    env = dict(os.environ)
    if sync:
        env["AUTOPROG_SYNC_SEARCH"] = "1"
    else:
        env.pop("AUTOPROG_SYNC_SEARCH", None)
    cmd = [sys.executable, "-m", "autoprog_tpu_torch.main_prog",
           "synthetic://", "--model", "volo_h4_l8", "--num-classes", "100",
           "--img-size", "128", "-b", "64", "--epochs", "2",
           "--warmup-epochs", "1", "--cooldown-epochs", "0",
           "--workers", "2", "--fake-data-size", str(fake_data_size),
           "--uint8-pipe",
           "--num-stages", "2", "--r-scale", "0.5", "--l-scale", "0.5",
           "--drop-path", "0.0", "--auto-grow", "--search-epochs", "1",
           "--search-probe-steps", str(probe_steps), "--load-with-clone-ema",
           "--model-ema", "--model-ema-decay", "0.99",
           "--output", out]
    print(f"== {tag}", flush=True)
    # the children's streams are inherited: a child that fails leaves its
    # traceback in this run's output
    subprocess.run(cmd, check=True, env=env, cwd=ROOT)
    logs = sorted(glob.glob(os.path.join(out, "train", "*", "log.txt")))
    return logs[-1]


def parse(log_path: str):
    ts = []
    probe_ts = []
    decision_ts = None
    first_probe_ts = None
    with open(log_path) as f:
        for line in f:
            m = re.match(r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2},\d{3})",
                         line)
            if not m:
                continue
            t = datetime.datetime.strptime(m.group(1),
                                           "%Y-%m-%d %H:%M:%S,%f")
            if "probe r" in line and "loss probe" in line:
                probe_ts.append(t)
                if first_probe_ts is None:
                    first_probe_ts = t
            if "auto grow decision" in line:
                decision_ts = t
            ts.append(t)
    # consecutive probe-start gaps = one probe each (the last probe of a
    # round is bounded by the next non-probe line; leaving it out keeps the
    # estimate conservative)
    deltas = sorted((b - a).total_seconds()
                    for a, b in zip(probe_ts, probe_ts[1:]))
    search_total = (decision_ts - first_probe_ts).total_seconds() \
        if decision_ts and first_probe_ts else float("nan")
    # the median: the few gaps between rounds (training chunks) land in the
    # tail
    per_probe = deltas[len(deltas) // 2] if deltas else float("nan")
    return per_probe, len(deltas), search_total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fake-data-size", type=int, default=2048)
    p.add_argument("--search-probe-steps", type=int, default=50)
    a = p.parse_args(argv)
    size = dict(fake_data_size=a.fake_data_size, probe_steps=a.search_probe_steps)
    base = os.path.join(ROOT, "output", "ab_search_sync")
    run("warmup (default loop, kernel libraries and allocator)",
        os.path.join(base, "warm"), sync=False, **size)
    log_s = run("per-step host reads (AUTOPROG_SYNC_SEARCH=1)",
                os.path.join(base, "sync"), sync=True, **size)
    log_d = run("device-side sums (default)", os.path.join(base, "desync"),
                sync=False, **size)
    for tag, lp in (("sync", log_s), ("desync", log_d)):
        pp, n, tot = parse(lp)
        print(f"{tag:<7s} per-probe {pp * 1e3:8.1f} ms (n={n})  "
              f"search phase {tot:7.1f} s", flush=True)
    pp_s, _, tot_s = parse(log_s)
    pp_d, _, tot_d = parse(log_d)
    print(f"per-probe cut {pp_s / max(pp_d, 1e-9):.2f}x, "
          f"search-phase cut {tot_s / max(tot_d, 1e-9):.2f}x")


if __name__ == "__main__":
    main()
