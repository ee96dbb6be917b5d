"""Progressive stage schedule (pure functions).

Capability parity with the reference's `prog/progressive.py:4-40` and the
small helpers `get_divisor` (`main_prog.py:2057`) / `no_repeats`
(`main_prog.py:2064`): linearly interpolate every growable quantity from
`scale * max` at stage 0 up to `max` at the final stage, with
hardware-friendly rounding (resolution to multiples of 32, heads to
multiples of 2).

Everything here is host-side numpy/python — these values select which
pre-compiled XLA program runs; they are never traced.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None,
                   round_limit: float = 0.9) -> int:
    """Round `v` to the nearest multiple of `divisor` (>= `min_value`),
    bumping up one step if rounding lost more than 10%.

    Mirrors reference `prog/progressive.py:34-40`.
    """
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def _linspace(lo_scale: float, n: int) -> np.ndarray:
    return np.linspace(lo_scale, 1.0, n)


@dataclasses.dataclass(frozen=True)
class ProgressiveSchedule:
    """Per-stage lists for every growable quantity.

    Fields mirror the 8-tuple returned by the reference's
    `progressive_schedule` (`prog/progressive.py:31`).
    """
    grow_epochs: Tuple[int, ...]          # epoch at which each stage starts
    resolutions: Tuple[int, ...]          # input resolution r (multiple of 32)
    heads: Tuple[int, ...]                # head count h (multiple of 2)
    layers: Tuple[int, ...]               # total depth l
    rand_aug: Tuple[str, ...]             # RandAugment policy string or ''
    drop_path: Tuple[float, ...]
    random_erase: Tuple[float, ...]
    crop_scale: Tuple[Tuple[float, float], ...]

    @property
    def num_stages(self) -> int:
        return len(self.grow_epochs)

    def stage_at_epoch(self, epoch: int) -> int:
        """Stage index active at `epoch` (stages begin at grow_epochs[i])."""
        stage = 0
        for i, e in enumerate(self.grow_epochs):
            if epoch >= e:
                stage = i
        return stage

    def stage(self, i: int):
        return dict(
            r=self.resolutions[i], h=self.heads[i], l=self.layers[i],
            aa=self.rand_aug[i], dp=self.drop_path[i],
            re=self.random_erase[i], resize=self.crop_scale[i],
        )


def progressive_schedule(
    *,
    num_stages: int,
    epochs: int,
    r_max: int = 224,
    h_max: int = 12,
    l_max: int = 18,
    r_scale: float = 0.5,
    h_scale: float = 1.0,
    l_scale: float = 0.5,
    aa_scale: float = 0.0,
    dp_scale: float = -0.5,
    re_scale: float = -0.5,
    resize_scale: Sequence[float] = (1.0, 1.0),
    aa_max: str = "rand-m9-mstd0.5-inc1",
    dp_max: float = 0.1,
    re_max: float = 0.25,
    resize_max: Sequence[float] = (0.08, 1.0),
) -> ProgressiveSchedule:
    """Build the per-stage growth schedule.

    Semantics match reference `prog/progressive.py:4-31`:
      * stage-start epochs = integer linspace over [0, epochs], first
        `num_stages` entries;
      * resolution rounded to /32, heads to /2, layers to /1;
      * RandAugment magnitude interpolated then re-encoded as a policy
        string ('' disables augment when the magnitude rounds to 0);
      * drop-path / random-erase / crop-scale linearly interpolated and
        clamped at 0 (negative scales start them at 0 for early stages).
    """
    e = [int(i) for i in np.linspace(0, epochs, num_stages + 1) // 1][:-1]
    r = [make_divisible(i, 32) for i in _linspace(r_scale, num_stages) * r_max]
    h = [make_divisible(i, 2) for i in _linspace(h_scale, num_stages) * h_max]
    l = [make_divisible(i, 1) for i in _linspace(l_scale, num_stages) * l_max]
    if not (isinstance(aa_max, str) and aa_max.startswith("rand")):
        raise ValueError(f"aa_max must be a rand-* policy string, got {aa_max!r}")
    m_aa_max = float(aa_max.split("-")[1].lstrip("m"))
    m_aa = [round(max(0.0, i)) for i in _linspace(aa_scale, num_stages) * m_aa_max]
    aa = [f"rand-m{m}-mstd0.5-inc1" if m > 0 else "" for m in m_aa]
    dp = [max(0.0, i) for i in _linspace(dp_scale, num_stages) * dp_max]
    re = [max(0.0, i) for i in _linspace(re_scale, num_stages) * re_max]
    resize = [
        (max(0.0, a), max(0.0, b))
        for a, b in zip(_linspace(resize_scale[0], num_stages) * resize_max[0],
                        _linspace(resize_scale[1], num_stages) * resize_max[1])
    ]
    return ProgressiveSchedule(
        grow_epochs=tuple(e),
        resolutions=tuple(r),
        heads=tuple(h),
        layers=tuple(l),
        rand_aug=tuple(aa),
        drop_path=tuple(dp),
        random_erase=tuple(re),
        crop_scale=tuple(resize),
    )


def get_divisor(number: int, factor: float) -> int:
    """Smallest divisor of `number` that is > number*factor.

    Used to rescale gradient-accumulation splits by the activation-memory
    ratio of the current sub-network (reference `main_prog.py:2057-2062`).
    """
    for i in range(int(number * factor) + 1, number + 1):
        if number % i == 0:
            return i
    return number


def no_repeats(a: Sequence) -> List:
    """Stable de-duplication (reference `main_prog.py:2064-2069`)."""
    b: List = []
    for e in a:
        if e not in b:
            b.append(e)
    return b
