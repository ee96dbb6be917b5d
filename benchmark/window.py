"""The measured window and its arithmetic.

Steps go back to back in a closed loop, as the trainer issues them: the
host runs ahead of the card, nothing inside the window waits for the
device. A CUDA event is recorded on the stream after every step (and one
before the first); the window ends with a synchronise. Afterwards:

  * the rate is all images of the window's steps over its wall time, from
    the host clock read after a synchronise before the first step to the
    one after the last;
  * a step interval is the device time between consecutive events; the
    tail is the 95th percentile of all of them (a per-layer metric,
    `metrics/step_ms_p95.py`).

On the CPU (the tests) the markers are host clock readings.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Sequence

import torch


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(n)] \
            if self.cuda else [0.0] * n

    def mark(self, i: int) -> None:
        if self.cuda:
            self.events[i].record()
        else:
            self.events[i] = time.perf_counter()

    def intervals_ms(self) -> List[float]:
        e = self.events
        if self.cuda:
            return [e[i].elapsed_time(e[i + 1]) for i in range(len(e) - 1)]
        return [(e[i + 1] - e[i]) * 1e3 for i in range(len(e) - 1)]


def estimate_ms(step: Callable[[int], object], start: int, n: int,
                device: torch.device) -> float:
    """Milliseconds a step, over `n` steps after a synchronise (set-up)."""
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(n):
        step(start + i)
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / n


def run(step: Callable[[int], torch.Tensor], start: int, n_steps: int,
        device: torch.device) -> Dict[str, object]:
    """`n_steps` steps (`step(i)` runs step i and returns its loss)."""
    marks = _Marks(n_steps + 1, device)
    losses = []
    synchronize(device)
    t0 = time.perf_counter()
    wall0 = time.time()
    marks.mark(0)
    for i in range(n_steps):
        losses.append(step(start + i))
        marks.mark(i + 1)
    synchronize(device)
    wall_s = time.perf_counter() - t0
    losses = torch.stack(losses).float()
    return {"steps": n_steps, "wall_s": wall_s, "start_time": wall0,
            "intervals_ms": marks.intervals_ms(),
            "nonfinite": int((~torch.isfinite(losses)).sum())}


def images_per_s(window: dict, images_per_step: int) -> float:
    """All images of the window's steps over its wall time."""
    return window["steps"] * images_per_step / window["wall_s"]


def step_p95(interval_sets: Sequence[List[float]]) -> float:
    """The 95th percentile of the step intervals (ms). Across chips,
    `interval_sets` holds every rank's intervals and a step's interval is
    its slowest rank's."""
    return percentile([max(vals) for vals in zip(*interval_sets)], 95)
