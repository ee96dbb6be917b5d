"""K1 (`mhsa_fused_qkv`) at the shapes the trainers give it, beside S1 at G = 1.

    python -m autoprog_tpu_torch.scripts.bench_k1 [repeats]

One row per shape: the four stages of the volo_d1 schedule at batch 128
(n = 64, 100, 144, 196 tokens; 12 heads of 32) and deit_small at batch 64
(n = 197; 6 heads of 64), bf16. Columns, in milliseconds per call (CUDA events
after a warm-up; the least of `repeats` rounds taken in turns, since calls
this short are also held to the host's launch rate):

  fwd, fwd f32   K1's forward at its default (bf16) scores and at f32 scores;
  fwd +stats     the forward that also writes the row statistics, as autograd
                 calls it when a backward will follow;
  bwd, bwd f32   K1's backward, fed the forward's statistics;
  loop_img1 fwd / bwd   `loop_img1` of `bench_attn_x` (S1, order loop, G = 1):
                 K1's walks at f32 scores with the next cell always in flight
                 in a second buffer, and the backward without the forward's
                 statistics (K1's bits at f32 scores).

`time_shape` takes further callables to time in the same turns (the smoke run
passes a library call as its yardstick; this package calls none). Without a
CUDA device the script raises unless AUTOPROG_TORCH_DEVICE=cpu, where it runs
the plain twins at batch 1 and the times mean nothing.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional

import torch

from autoprog_tpu_torch.ops import attention as A
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.scripts import bench_attn_x as X
from autoprog_tpu_torch.scripts.timing import card_name, time_call

#: (batch, tokens, heads, head_dim): the volo_d1 stages and deit_small
SHAPES = [(128, 64, 12, 32), (128, 100, 12, 32), (128, 144, 12, 32), (128, 196, 12, 32),
          (64, 197, 6, 64)]
COLUMNS = ("fwd", "fwd f32", "fwd +stats", "bwd", "bwd f32", "loop_img1 fwd", "loop_img1 bwd")


def inputs(B: int, n: int, heads: int, d: int, device: torch.device, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, n, 3 * heads * d, generator=gen).to(device, torch.bfloat16)
    dout = torch.randn(B, n, heads * d, generator=gen).to(device, torch.bfloat16)
    return qkv, dout


def time_shape(qkv: torch.Tensor, dout: torch.Tensor, heads: int, iters: int = 30,
               repeats: int = 3,
               extra: Optional[Dict[str, Callable[[], object]]] = None) -> Dict[str, float]:
    """{column: ms} for one shape; `extra` callables are timed in the same turns."""
    scale = (qkv.shape[2] // 3 // heads) ** -0.5
    device = qkv.device
    if device.type == "cuda":
        stats = {sf: A._launch_fwd(qkv, heads, scale, sf, want_stats=True)[1]
                 for sf in (False, True)}
        calls = {
            "fwd": lambda: A._launch_fwd(qkv, heads, scale, False),
            "fwd f32": lambda: A._launch_fwd(qkv, heads, scale, True),
            "fwd +stats": lambda: A._launch_fwd(qkv, heads, scale, False, want_stats=True),
            "bwd": lambda: A._launch_bwd(qkv, dout, heads, scale, False, stats[False]),
            "bwd f32": lambda: A._launch_bwd(qkv, dout, heads, scale, True, stats[True]),
            "loop_img1 fwd": lambda: X._launch_group_fwd("loop", 1, qkv, heads, scale),
            "loop_img1 bwd": lambda: X._launch_group_bwd("loop", 1, qkv, dout, heads, scale),
        }
    else:
        stats = {sf: A.mhsa_fused_qkv_reference(qkv, heads, scale, sf, True)[1]
                 for sf in (False, True)}
        calls = {
            "fwd": lambda: A.mhsa_fused_qkv_reference(qkv, heads, scale, False),
            "fwd f32": lambda: A.mhsa_fused_qkv_reference(qkv, heads, scale, True),
            "fwd +stats": lambda: A.mhsa_fused_qkv_reference(qkv, heads, scale, False, True),
            "bwd": lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, heads, scale, False,
                                                               stats[False]),
            "bwd f32": lambda: A.mhsa_fused_qkv_backward_reference(qkv, dout, heads, scale,
                                                                   True, stats[True]),
            "loop_img1 fwd": lambda: X.group_reference(qkv, heads, scale),
            "loop_img1 bwd": lambda: X.group_backward_reference(qkv, dout, heads, scale),
        }
    calls.update(extra or {})
    ms = {key: float("inf") for key in calls}
    order = list(calls)
    for turn in range(repeats):
        warmup = 0 if device.type != "cuda" else 3 if turn == 0 else 1
        for key in (order if turn % 2 == 0 else order[::-1]):
            ms[key] = min(ms[key], time_call(calls[key], iters, warmup, device))
    return ms


def main(argv: Optional[List[str]] = None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    device = default_device()
    on_card = device.type == "cuda"
    repeats = int(argv[0]) if argv else (3 if on_card else 1)
    iters = 30 if on_card else 1
    print(f"bf16, {iters} iters, least of {repeats} rounds, on {card_name(device)}", flush=True)
    rows = []
    for B, n, heads, d in SHAPES:
        qkv, dout = inputs(B if on_card else 1, n, heads, d, device)
        ms = time_shape(qkv, dout, heads, iters, repeats)
        rows.append({"B": qkv.shape[0], "n": n, "heads": heads, "d": d, **ms})
        print(f"B={qkv.shape[0]:<3d} n={n:<3d} heads={heads:<2d} d={d:<2d} "
              + "  ".join(f"{key} {ms[key]:.4f}" for key in COLUMNS), flush=True)
    return rows


if __name__ == "__main__":
    main()
