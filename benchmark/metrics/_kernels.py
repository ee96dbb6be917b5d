"""Shared by the kernel roofline readers: the device time of the kernels
whose names match, in the profiled slice of rank 0."""

from __future__ import annotations

import re
from typing import Optional, Sequence


def matched_us(kernels: Sequence[tuple], pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(d for name, _, d in kernels if rx.search(name))


def share_pct(least_s_per_step: float, kernels, pattern: str, steps: int) -> Optional[float]:
    """The least time of the slice's work over the matched kernels' device
    time, in %; None where no kernel matches."""
    t_us = matched_us(kernels, pattern)
    if t_us <= 0:
        return None
    return 100.0 * least_s_per_step * steps / (t_us * 1e-6)
