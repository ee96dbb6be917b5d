"""Timing for the measurement scripts: CUDA events around many calls after a
warm-up. PyTorch returns before the device finishes, so a host clock alone
would measure the enqueue. On the CPU (tests) it is `time.perf_counter`."""

from __future__ import annotations

import time
from typing import Callable

import torch


def time_call(fn: Callable[[], object], iters: int, warmup: int = 3,
              device: torch.device = torch.device("cuda")) -> float:
    """Milliseconds per call of `fn` over `iters` calls, after `warmup`."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def card_name(device: torch.device) -> str:
    """What the times were taken on: `nvidia-smi`'s name and power limit for
    a CUDA device, "cpu" otherwise."""
    if device.type != "cuda":
        return "cpu"
    import subprocess
    idx = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(idx)],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() if smi.returncode == 0 else torch.cuda.get_device_name(idx)
