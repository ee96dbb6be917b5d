"""Shared by the readers of the program's spans (`stem_ms`, `outlookers_ms`,
`transformers_ms`, `head_loss_ms`, `update_ms`, `host_lead_ms`): the records
that `autoprog_tpu_torch.utils.spans` kept over the profiled slice, in this
process (rank 0's). The second module of the benchmark that reads the
program, after `program.py`, and for the spans only. A program without that
module, or that recorded no `step` span, gives no records, and every reader
then returns None.

A record holds a span's name, its parent, its step, its host interval and
its device interval (the CUDA events around the work it launched, placed on
the host clock; off the card, host-clock readings). A segment's time is the
sum over the slice of its spans' device intervals, forward (`<name>`) and
backward (`<name>.bwd`), over the slice's steps: idle time inside a segment
counts."""

from __future__ import annotations

import collections
import statistics
import sys
from typing import Dict, List, Optional, Sequence

#: the spans the step's time is cut into; their union is the step but for
#: the host's time between two of them
LEAVES = ("step.input", "model.stem", "model.outlookers", "model.transformers", "model.head",
          "step.loss", "model.stem.bwd", "model.outlookers.bwd", "model.transformers.bwd",
          "model.head.bwd", "step.update")


def records() -> list:
    try:
        from autoprog_tpu_torch.utils import spans
    except ImportError:
        return []
    recs = spans.records()
    return recs if any(r.name == "step" for r in recs) else []


def _ms(r) -> float:
    return (r.device_ns[1] - r.device_ns[0]) * 1e-6


def per_step_ms(recs: Sequence, names: Sequence[str]) -> Optional[float]:
    """Device ms a step of the spans named `names`; None where none ran."""
    steps = sum(r.name == "step" for r in recs)
    found = [r for r in recs if r.name in names and r.device_ns is not None]
    if not steps or not found:
        return None
    return sum(_ms(r) for r in found) / steps


def segment_ms(*segments: str) -> Optional[float]:
    """Forward plus backward device ms a step of the segments named (a span
    without a backward counts its forward alone)."""
    return per_step_ms(records(), [n for s in segments for n in (s, s + ".bwd")])


def _step_of(recs: Sequence, i: int) -> Optional[int]:
    """The index of the `step` span that encloses record i."""
    while i >= 0:
        if recs[i].name == "step":
            return i
        i = recs[i].parent
    return None


def host_lead_ms(recs: Sequence) -> Optional[float]:
    """At each leaf span's open: the device time at which its open event
    completed less the host time at which it was recorded. The median over
    the steps of each step's least lead; None off the card. On stderr: the
    span where the least lead falls most often, and each segment's time
    forward and backward."""
    if not recs or not recs[0].on_card:
        return None
    parents = {r.parent for r in recs}
    least: Dict[int, tuple] = {}
    for i, r in enumerate(recs):
        step = _step_of(recs, i)
        if i in parents or step is None or r.device_ns is None:
            continue
        lead = (r.device_ns[0] - r.host_ns[0]) * 1e-6
        if step not in least or lead < least[step][0]:
            least[step] = (lead, r.name)
    if not least:
        return None
    where = collections.Counter(name for _, name in least.values()).most_common(1)[0]
    print(f"# host_lead_ms: least lead at {where[0]} in {where[1]} of {len(least)} steps; "
          f"least leads {[round(v, 3) for v, _ in least.values()]}", file=sys.stderr)
    return statistics.median(v for v, _ in least.values())


def report(recs: Sequence, kernels_ms: Dict[str, float]) -> None:
    """Each segment's device ms a step forward and backward (and the
    update's two largest parts), the share of the `step` spans' device time
    that the leaf segments cover, and beside them the kernel times named in
    `kernels_ms` (ms a step)."""
    parts: List[str] = []
    for seg in ("model.stem", "model.outlookers", "model.transformers", "model.head",
                "step.input", "step.loss", "step.update", "update.optimizer", "update.ema"):
        fwd, bwd = per_step_ms(recs, [seg]), per_step_ms(recs, [seg + ".bwd"])
        if fwd is not None:
            parts.append(f"{seg} {fwd:.3f}" + ("" if bwd is None else f" + {bwd:.3f} bwd"))
    whole, leaves = per_step_ms(recs, ["step"]), per_step_ms(recs, LEAVES)
    cover = "" if not whole else f"; leaf segments cover {100 * (leaves or 0) / whole:.2f} %"
    print(f"# spans, ms a step: step {whole:.3f}{cover}: " + ", ".join(parts) +
          "".join(f"; {k} kernels {v:.3f}" for k, v in kernels_ms.items()), file=sys.stderr)
