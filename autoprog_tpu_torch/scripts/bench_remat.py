"""The full train step with and without rematerialisation, counterpart of
the JAX package's `scripts/bench_remat.py`.

    python -m autoprog_tpu_torch.scripts.bench_remat [--model M] [--batch B]
        [--img R] [--iters N] [--modes off dots full]

`bench.py`'s step (token labels, MixToken, AdamW, 4 EMA decays, bf16) of
`--model` at `--img` px under each remat mode of the blocks
(`models/layers.py:remat_call`):

  off   store every activation;
  dots  keep the linear layers' outputs, recompute the rest of each block;
  full  keep only each block's input, recompute the whole block.

One train state is chained through the modes (the mode is the model's
`remat` attribute; the parameters and the optimizer's state have the same
shapes in every mode, and a second state would only hold memory). Each
mode's row: ms a step (CUDA events around `--iters` steps after a warm-up,
`bench.time_step`), img/s, its ratio to `off`, and the peak device memory
of its steps (`torch.cuda.max_memory_allocated`; on the card the trade is
memory for time). The rows go to stderr; the last line of stdout is one
JSON object with them, the launches of K1 and K2 and the card's name and
power limit. With AUTOPROG_TORCH_DEVICE=cpu (the tests) the defaults are
batch 8 and one step; such times say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> Dict:
    from autoprog_tpu_torch import bench
    from autoprog_tpu_torch.platform import default_device
    from autoprog_tpu_torch.ops import launch_counts, launches_since
    from autoprog_tpu_torch.scripts.timing import card_name

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="volo_h12_l18")
    p.add_argument("--batch", type=int, default=0, help="0: 128 on the card, 8 on the CPU")
    p.add_argument("--img", type=int, default=224)
    p.add_argument("--iters", type=int, default=0, help="0: 20 on the card, 1 on the CPU")
    p.add_argument("--modes", nargs="+", default=["off", "dots", "full"],
                   choices=["off", "dots", "full"])
    args = p.parse_args(argv)
    device = default_device()
    on_card = device.type == "cuda"
    batch = args.batch or (128 if on_card else 8)
    iters = args.iters or (20 if on_card else 1)
    warmup = 3 if on_card else 0
    sb, state, data = bench.make_step(device, batch, model=args.model, img_size=args.img)
    card = card_name(device)
    print(f"{args.model} b={batch} img={args.img} on {card}", file=sys.stderr)
    start = launch_counts()
    rows = []
    for mode in args.modes:
        state.model.remat = "" if mode == "off" else mode
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t = bench.time_step(sb, state, data, 1.6e-3, r=args.img, iters=iters, warmup=warmup)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None
        rows.append({"mode": mode, "ms": t * 1e3, "img_per_s": batch / t, "peak_gib": peak})
        print(f"remat={mode:<5s} {t * 1e3:8.2f} ms/step  {batch / t:7.1f} img/s"
              + (f"  peak {peak:.2f} GiB" if peak is not None else ""), file=sys.stderr)
    base = next((r["ms"] for r in rows if r["mode"] == "off"), None)
    for r in rows:
        r["vs_off"] = base / r["ms"] if base else None
        if base and r["mode"] != "off":
            print(f"{r['mode']} vs off: {r['vs_off']:.3f}x", file=sys.stderr)
    launches = launches_since(start)
    result = {"metric": "train_step_remat_ms", "model": args.model, "batch": batch,
              "img_size": args.img, "card": card, "rows": rows, "launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
