"""Tensor ops of the port: plain PyTorch, plus the K1 attention kernel."""

from typing import Dict


def launch_counts() -> Dict[str, Dict[str, int]]:
    """K1's and K2's launch counters as they stand, forward and backward
    (`ops/attention.LAUNCHES`, `ops/outlook_fused.LAUNCHES`)."""
    from autoprog_tpu_torch.ops import attention, outlook_fused
    return {"K1": {s: attention.LAUNCHES[s] for s in ("fwd", "bwd")},
            "K2": {s: outlook_fused.LAUNCHES[s] for s in ("fwd", "bwd")}}


def launches_since(start: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """K1's and K2's launches since `start = launch_counts()`."""
    now = launch_counts()
    return {k: {s: now[k][s] - start[k][s] for s in now[k]} for k in now}
