"""Tensor ops of the port: plain PyTorch, plus the CUDA kernels (K1, K2,
LayerNorm) beside their twins."""

from typing import Dict


def launch_counts() -> Dict[str, Dict[str, int]]:
    """K1's, K2's and LayerNorm's launch counters as they stand, forward and
    backward (`ops/attention.LAUNCHES`, `ops/outlook_fused.LAUNCHES`,
    `ops/layernorm.LAUNCHES`: two launches a LayerNorm backward)."""
    from autoprog_tpu_torch.ops import attention, layernorm, outlook_fused
    return {"K1": {s: attention.LAUNCHES[s] for s in ("fwd", "bwd")},
            "K2": {s: outlook_fused.LAUNCHES[s] for s in ("fwd", "bwd")},
            "LN": {s: layernorm.LAUNCHES[s] for s in ("fwd", "bwd")}}


def launches_since(start: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """The launches of `launch_counts()` since `start = launch_counts()`."""
    now = launch_counts()
    return {k: {s: now[k][s] - start[k][s] for s in now[k]} for k in now}
