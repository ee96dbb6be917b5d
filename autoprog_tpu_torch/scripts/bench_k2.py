"""K2 (`outlook_attention_fused`, forward and backward) at the maps the
trainers give it, beside the general kernels and the unfused op.

    python -m autoprog_tpu_torch.scripts.bench_k2 [repeats]

One row per map: the outlooker's map at the four stages of the volo_d1
schedule at batch 128 ([128, r/8, r/8, 192] with 6 heads for r = 128, 160,
192, 224) and the volo_d4 width at 224 px ([128, 28, 28, 384], 12 heads),
bf16, and the volo_d1 map at 224 px once more in f32 (the route of an f32
model). Columns, in milliseconds per call (CUDA events after a warm-up; the
least of `repeats` rounds taken in turns):

  fwd, bwd          K2 as the port runs it: the streamed row kernels;
  general fwd/bwd   the general kernels (a thread per channel of a quad,
                    whole f32 tiles, a two-kernel backward), which were K2
                    before the row kernels and still take the shapes these
                    do not;
  unfused fwd, unfused fwd+bwd
                    `ops/outlook.py` (PyTorch unfold, softmax, matmul, fold)
                    and its autograd backward;
  bound fwd/bwd     the least time the card could take: every input read once
                    and every output written once at 3.35 TB/s, against 81
                    f32 multiply-adds per window, head and channel (twice
                    that backward) at 67 TFLOP/s.

`time_shape` takes further callables to time in the same turns. Without a
CUDA device the script raises unless AUTOPROG_TORCH_DEVICE=cpu, where it runs
the plain twins at batch 1 and the times mean nothing.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional

import torch

from autoprog_tpu_torch.ops import outlook_fused as O
from autoprog_tpu_torch.ops.outlook import outlook_attention
from autoprog_tpu_torch.platform import default_device
from autoprog_tpu_torch.scripts import cost
from autoprog_tpu_torch.scripts.timing import card_name, time_call

#: (batch, H = W, C, heads, dtype): the volo_d1 stages and the volo_d4 width
#: in bf16, the volo_d1 map at 224 px in f32
SHAPES = [(128, 16, 192, 6, "bf16"), (128, 20, 192, 6, "bf16"), (128, 24, 192, 6, "bf16"),
          (128, 28, 192, 6, "bf16"), (128, 28, 384, 12, "bf16"), (128, 28, 192, 6, "f32")]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
COLUMNS = ("fwd", "bwd", "general fwd", "general bwd", "unfused fwd", "unfused fwd+bwd")


def inputs(B: int, H: int, C: int, heads: int, device: torch.device, seed: int = 0,
           dtype: str = "bf16"):
    """v, logits (2 x N(0, 1)) and the output gradient in `dtype`."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(B, H, H, C, generator=gen)
    logits = 2 * torch.randn(B, H // 2, H // 2, heads * 81, generator=gen)
    gout = torch.randn(B, H, H, C, generator=gen)
    return tuple(t.to(device, DTYPES[dtype]) for t in (v, logits, gout))


def bound(B: int, H: int, W: int, C: int, heads: int, item: int = 2):
    """{side: (least ms, "bytes" or "operations")} of K2's work
    (`scripts/cost.py`) at the f32 peak."""
    out = {}
    for side in ("fwd", "bwd"):
        flops, nbytes = cost.k2_work(side, B, H, W, C, heads, item)
        out[side] = cost.least_ms(nbytes, flops, cost.F32_FLOPS)
    return out


def time_shape(v: torch.Tensor, logits: torch.Tensor, gout: torch.Tensor, heads: int,
               iters: int = 30, repeats: int = 3,
               extra: Optional[Dict[str, Callable[[], object]]] = None) -> Dict[str, float]:
    """{column: ms} for one map; `extra` callables are timed in the same turns."""
    C = v.shape[-1]
    scale = (C // heads) ** -0.5
    device = v.device
    vr, lr = v.clone().requires_grad_(True), logits.clone().requires_grad_(True)

    def unfused(a, b):
        return outlook_attention(a, b, num_heads=heads, kernel_size=3, stride=2, padding=1,
                                 scale=scale)

    def unfused_fwd_bwd():
        vr.grad = lr.grad = None
        unfused(vr, lr).backward(gout)

    if device.type == "cuda":
        calls = {
            "fwd": lambda: O._launch_fwd(v, logits, heads, scale),
            "bwd": lambda: O._launch_bwd(v, logits, gout, heads, scale),
            "general fwd": lambda: O._launch_fwd(v, logits, heads, scale, general=True),
            "general bwd": lambda: O._launch_bwd(v, logits, gout, heads, scale, general=True),
        }
    else:
        calls = {
            "fwd": lambda: O.outlook_attention_fused_reference(v, logits, heads, scale),
            "bwd": lambda: O.outlook_attention_backward_reference(v, logits, gout, heads,
                                                                  scale),
        }
        calls["general fwd"], calls["general bwd"] = calls["fwd"], calls["bwd"]
    calls["unfused fwd"] = lambda: unfused(v, logits)
    calls["unfused fwd+bwd"] = unfused_fwd_bwd
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
    print(f"{iters} iters, least of {repeats} rounds, on {card_name(device)}", flush=True)
    rows = []
    for B, H, C, heads, dtype in SHAPES:
        B = B if on_card else 1
        v, logits, gout = inputs(B, H, C, heads, device, dtype=dtype)
        ms = time_shape(v, logits, gout, heads, iters, repeats)
        lim = bound(B, H, H, C, heads, v.element_size())
        rows.append({"B": B, "H": H, "C": C, "heads": heads, "dtype": dtype, **ms,
                     "bound fwd": lim["fwd"][0], "bound bwd": lim["bwd"][0]})
        print(f"[{B}, {H}, {H}, {C}] heads={heads:<2d} {dtype:4s} "
              + "  ".join(f"{key} {ms[key]:.4f}" for key in COLUMNS)
              + f"  bound fwd {lim['fwd'][0]:.4f} ({lim['fwd'][1]}) bwd {lim['bwd'][0]:.4f} "
              f"({lim['bwd'][1]})", flush=True)
    return rows


if __name__ == "__main__":
    main()
