#!/usr/bin/env python
"""Summarize a rehearsal run pair (autoprog vs fixed) from their logs, a
copy of the JAX package's `scripts/analyze_rehearsal.py` (it reads the
trainers' log lines, which both packages write alike, and imports nothing of
the repo; `tests/test_torch_copies.py` holds it to its original).

Parses per-epoch stage configs, img/s, epoch wall-times (train-loop time
from consecutive `Train: e [0/..]` to the epoch's last log), search
epochs, decisions, and eval metrics; prints the per-stage table PERF.md
records (`rehearsal_flagship.sh`).

Usage: python -m autoprog_tpu_torch.scripts.analyze_rehearsal AUTOPROG_LOG [FIXED_LOG]
       (or AUTOPROG_LOG... --fixed FIXED_LOG for a resumed run's logs)
"""

from __future__ import annotations

import re
import sys
from datetime import datetime


def ts(line: str):
    m = re.match(r"(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}),(\d{3})", line)
    if not m:
        return None
    return datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S").timestamp() \
        + int(m.group(2)) / 1e3


def parse(path: str):
    events = []
    for line in open(path, errors="replace"):
        t = ts(line)
        if t is None:
            continue
        m = re.search(r"Train(Super)?: (\d+) \[\s*(\d+)/(\d+)\]", line)
        if m:
            rate = re.search(r"([\d.]+) img/s", line)
            events.append(dict(t=t, kind="super" if m.group(1) else "train",
                               epoch=int(m.group(2)), step=int(m.group(3)),
                               nb=int(m.group(4)),
                               rate=float(rate.group(1)) if rate else 0.0))
            continue
        m = re.search(r"stage (\d+): \{'r': (\d+), 'h': (\d+), 'l': (\d+)",
                      line)
        if m:
            events.append(dict(t=t, kind="stage", stage=int(m.group(1)),
                               r=int(m.group(2)), h=int(m.group(3)),
                               l=int(m.group(4))))
            continue
        m = re.search(r"auto grow decision: r=(\d+) l=(\d+)", line)
        if m:
            events.append(dict(t=t, kind="decision", r=int(m.group(1)),
                               l=int(m.group(2))))
            continue
        m = re.search(r"Test: loss ([\d.]+)\s+Acc@1 ([\d.]+)", line)
        if m:
            events.append(dict(t=t, kind="eval", loss=float(m.group(1)),
                               top1=float(m.group(2))))
            continue
        m = re.search(r"total train time: ([\d.]+)s", line)
        if m:
            events.append(dict(t=t, kind="total", s=float(m.group(1))))
    return events


def epoch_times(events):
    """epoch -> (wall seconds spent in the train loop, last rate)."""
    out = {}
    cur = None
    for e in events:
        if e["kind"] in ("train", "super"):
            key = (e["kind"], e["epoch"])
            if cur is None or cur[0] != key:
                cur = (key, e["t"])
            out[key] = dict(start=cur[1], end=e["t"], rate=e["rate"],
                            nb=e["nb"])
    return {k: dict(v, wall=v["end"] - v["start"]) for k, v in out.items()}


def summarize(path, label: str):
    """`path` is one log or a list of logs from a resumed run: later
    attempts override earlier ones per (kind, epoch) — a resume re-runs
    its landing epoch, and the attempt that completed it is
    authoritative (PERF.md's per-epoch table is this function's
    output)."""
    paths = [path] if isinstance(path, str) else list(path)
    ev = []
    et = {}
    for p in paths:
        ev_p = parse(p)
        ev.extend(ev_p)
        et.update(epoch_times(ev_p))
    path = " + ".join(paths)
    stages = [e for e in ev if e["kind"] == "stage"]
    decisions = [e for e in ev if e["kind"] == "decision"]
    evals = [e for e in ev if e["kind"] == "eval"]
    total = [e for e in ev if e["kind"] == "total"]
    print(f"\n=== {label}: {path}")
    for d in decisions:
        print(f"  decision: r={d['r']} l={d['l']}")
    for s in stages:
        print(f"  stage {s['stage']}: r={s['r']} h={s['h']} l={s['l']}")
    print(f"  {'epoch':>10s} {'kind':>6s} {'loop s':>7s} {'img/s':>7s}")
    for (kind, ep), v in sorted(et.items(), key=lambda kv: kv[1]["start"]):
        # full-epoch wall extrapolated from logged steps
        frac = max(v["nb"] - 1, 1)
        print(f"  {ep:>10d} {kind:>6s} {v['wall']:7.1f} {v['rate']:7.1f}")
    if evals:
        print(f"  final eval top-1: {evals[-1]['top1']:.3f} "
              f"(loss {evals[-1]['loss']:.4f})")
    if total:
        print(f"  total train-loop time: {total[-1]['s']:.1f}s")
    if ev:
        print(f"  wall clock first->last log: {ev[-1]['t'] - ev[0]['t']:.1f}s")


def main():
    argv = sys.argv[1:]
    if "--fixed" in argv:
        i = argv.index("--fixed")
        auto, fixed = argv[:i], argv[i + 1:]
        summarize(auto, "autoprog (stitched)" if len(auto) > 1
                  else "autoprog")
        if fixed:
            summarize(fixed[0], "fixed")
        return
    summarize(argv[0], "autoprog")
    if len(argv) > 1:
        summarize(argv[1], "fixed")


if __name__ == "__main__":
    main()
