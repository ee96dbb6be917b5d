"""Metric meters (reference: timm `AverageMeter` + `prog/metrics.py:1-18`)."""

from __future__ import annotations

from collections import deque


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class SmoothMeter:
    """Sliding-window average (window 50), one per (r, l) search cell
    (`prog/metrics.py`, used at `main_prog.py:1873-1875`)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.buf = deque(maxlen=window)
        self.val = 0.0

    def update(self, val: float, n: int = 1):
        # reference appends `val` n times (`prog/metrics.py:13-16`)
        self.val = float(val)
        self.buf.extend([float(val)] * max(int(n), 1))

    @property
    def avg(self) -> float:
        return sum(self.buf) / max(len(self.buf), 1)
