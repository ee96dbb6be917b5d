"""Outlook-attention formulations at the volo_d1 stage-0 shape, counterpart
of the JAX package's `scripts/bench_outlook.py`.

    python -m autoprog_tpu_torch.scripts.bench_outlook [batch] [--blockdiag] [--fused]

At v [B, 28, 28, 192], 6 heads, logits [B, 14, 14, 6 x 81], bf16 (B = 128 on
the card), each row times the op's forward (no grad) and its forward and
backward (the gradients of sum(out^2) in f32 to v and the logits), in
milliseconds per call (CUDA events around `iters` calls after a warm-up,
`scripts/timing.py`):

  broadcast (default)     `ops/outlook.py:outlook_attention`, autograd's backward;
  broadcast custom-vjp    `outlook_attention_cvjp`, the hand-written backward;
  blockdiag g=4, 7, 14, 28  with --blockdiag: `outlook_attention_blockdiag`;
  K2 fused, K3 hybrid, K4 hybrid2
                          with --fused (the JAX script's --pallas): the port's
                          CUDA kernels (`ops/outlook_fused.py`), each with K2's
                          backward.

A --fused row is named after its kernel only where the kernel ran: the row
counts the launches it made (`ops/outlook_fused.LAUNCHES`), and a row whose
kernel did not launch (the plain twins on the CPU) carries "[plain twin]"
in its name. The table goes to stderr; the last line of stdout is one JSON
object with the rows, their launches, the shape and the card's name and
power limit. With AUTOPROG_TORCH_DEVICE=cpu (the tests) it runs at batch 4
by default, one call a row; such times say nothing of the card.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import Dict, List, Optional

import torch

H = W = 28            # the stage-0 map at 224 px
C, HEADS = 192, 6     # volo_d1
#: the --fused rows: (name, the function of ops/outlook_fused.py, the counter
#: of its forward kernel)
FUSED = (("K2 fused", "outlook_attention_fused", "fwd"),
         ("K3 hybrid", "outlook_attention_hybrid", "attend_hm"),
         ("K4 hybrid2", "outlook_attention_hybrid2", "attend"))


def main(argv: Optional[List[str]] = None) -> Dict:
    from autoprog_tpu_torch.ops import outlook as U
    from autoprog_tpu_torch.ops import outlook_fused as O
    from autoprog_tpu_torch.platform import default_device
    from autoprog_tpu_torch.scripts.timing import card_name, time_call

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=None)
    p.add_argument("--blockdiag", action="store_true")
    p.add_argument("--fused", action="store_true")
    opts = p.parse_args(argv)
    device = default_device()
    on_card = device.type == "cuda"
    B = opts.batch or (128 if on_card else 4)
    iters, warmup = (30, 3) if on_card else (1, 0)
    scale = (C // HEADS) ** -0.5
    gen = torch.Generator().manual_seed(0)
    v = torch.randn(B, H, W, C, generator=gen).to(device, torch.bfloat16)
    attn = torch.randn(B, H // 2, W // 2, HEADS * 81, generator=gen).to(device, torch.bfloat16)

    kw = dict(num_heads=HEADS, kernel_size=3, stride=2, padding=1, scale=scale)
    variants = {"broadcast (default)": functools.partial(U.outlook_attention, **kw),
                "broadcast custom-vjp": functools.partial(U.outlook_attention_cvjp, **kw)}
    if opts.blockdiag:
        for g in (4, 7, 14, 28):
            variants[f"blockdiag g={g}"] = functools.partial(
                U.outlook_attention_blockdiag, group=g, **kw)
    kernels = {}
    if opts.fused:
        for name, fn, counter in FUSED:
            variants[name] = functools.partial(getattr(O, fn), num_heads=HEADS, scale=scale)
            kernels[name] = counter
    vr, ar = v.clone().requires_grad_(True), attn.clone().requires_grad_(True)

    card = card_name(device)
    print(f"B={B} H=W={H} C={C} heads={HEADS} bf16 ({iters} iters) on {card}", file=sys.stderr)
    rows = []
    for name, fn in variants.items():
        before = dict(O.LAUNCHES)
        with torch.no_grad():
            t_f = time_call(lambda: fn(v, attn), iters, warmup, device)

        def both(fn=fn):
            loss = fn(vr, ar).float().pow(2).sum()
            return torch.autograd.grad(loss, (vr, ar))
        t_b = time_call(both, iters, warmup, device)
        launches = {k: O.LAUNCHES[k] - before[k] for k in O.LAUNCHES}
        if name in kernels and not (launches[kernels[name]] and launches["bwd"]):
            name += " [plain twin]"
        rows.append({"name": name, "fwd_ms": t_f, "fwd_bwd_ms": t_b, "launches": launches})
        print(f"{name:<32s} fwd {t_f:8.3f} ms   fwd+bwd {t_b:8.3f} ms", file=sys.stderr)
    result = {"metric": "outlook_attention_ms", "batch": B, "shape": [B, H, W, C],
              "heads": HEADS, "dtype": "bfloat16", "card": card, "rows": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
