"""The profiled slice of a `--trace 1` run and its reduction.

After the measured window, `TRACE_STEPS` more steps run under
`torch.profiler`, each inside a `bench.step` span of the benchmark's own. On
the card it records CUDA activity only: the device's kernels, copies and
sets, and on the host the CUDA runtime calls (launches, copies,
synchronisations).
Recording every host operation as well would slow the host by tens of
milliseconds a step and idle the card for that reason alone. The trace
stays in memory; it is reduced here to

  * `kernels`: every device activity (kernels, copies, sets) as
    (name, start_us, duration_us), what the per-layer readers match;
  * `busy_s`: the union of those intervals; `window_s`: the slice's wall
    time by the host clock, from a synchronise before it to one after;
  * the breakdown: the device operations that took most time, and the
    idle gaps between device activities by the innermost host operation
    running in the middle of each gap (a CUDA runtime call, or none: the
    host was in Python or PyTorch between calls).
"""

from __future__ import annotations

import collections
import heapq
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

TOP = 10
#: steps of the profiled slice: enough for every kernel of a step to show,
#: few enough that the trace stays small in memory
TRACE_STEPS = 6
Kernel = Tuple[str, float, float]


def busy_us(kernels: Sequence[Kernel]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, -float("inf")
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        e = s + d
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(kernels: Sequence[Kernel]) -> List[Tuple[float, float]]:
    """The idle intervals (start_us, end_us) between device activities."""
    out, end = [], None
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            out.append((end, s))
        end = s + d if end is None else max(end, s + d)
    return out


def breakdown(kernels: Sequence[Kernel], host_ops: Sequence[Kernel]) -> Dict[str, list]:
    """The top device operations by total seconds, and idle seconds by the
    host operation under each gap (summed over gaps of that name)."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for name, _, d in kernels:
        by_name[_short(name)] += d * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    hosts = sorted(host_ops, key=lambda h: h[1])
    active: List[Tuple[float, float, str]] = []      # heap of (end, duration, name)
    j = 0
    for a, b in gaps(kernels):                       # in time order
        mid = (a + b) / 2
        while j < len(hosts) and hosts[j][1] <= mid:
            n, s, d = hosts[j]
            heapq.heappush(active, (s + d, d, n))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda x: x[1])[2] if active else "(no host operation)"
        idle[name] += (b - a) * 1e-6
        count[name] += 1
    idle_rows = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{n} (x{count[n]})", s] for n, s in idle_rows]}


def _short(name: str, limit: int = 120) -> str:
    name = name.replace("\n", " ").replace("\t", " ")
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _events(prof):
    """(device activities, host operations) as (name, start_us, dur_us). A
    span opened on the host (`record_function`, the optimizer's step) is
    mirrored on the device's timeline as an annotation under its own name;
    it is no device activity and is left out."""
    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.elapsed_us())
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(row)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(row)
    names = {h[0] for h in host}
    return [d for d in dev if d[0] not in names], host


def profile(step: Callable[[int], object], start: int, n_steps: int,
            device: torch.device) -> dict:
    """Run `n_steps` steps under the profiler and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            with record_function("bench.step"):
                step(start + i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = _events(prof)
    return {"steps": n_steps, "window_s": window_s, "kernels": dev,
            "busy_s": busy_us(dev) * 1e-6, "breakdown": breakdown(dev, host)}
