"""The train step of the large VOLO variants on one card, counterpart of
the JAX package's `scripts/bench_family.py`.

    python -m autoprog_tpu_torch.scripts.bench_family [--iters N]

For each entry of `CONFIGS` (volo_d4 at batch 32 and volo_d5 at batch 8,
both with `--remat full`, as the JAX script runs them): `bench.py`'s step
(token labels, MixToken, AdamW, one EMA decay, bf16) at 224 px, timed over
`--iters` steps after a warm-up (CUDA events, `bench.time_step`), with the
parameter count and the peak device memory of its steps. VOLO-D4 runs K1 at
head_dim 48 in its transformer blocks.

The JAX script prints FAILED for a configuration that does not run and
goes on; here an error or an out-of-memory ends the run with a nonzero
exit. Importing the module runs nothing: a test shrinks `CONFIGS` (and
`bench.IMG_SIZE`). The rows go to stderr; the last line of stdout is one
JSON object with them, the launches of K1 and K2 and the card's name and
power limit. With AUTOPROG_TORCH_DEVICE=cpu (the tests) it takes one step
a configuration; such times say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import torch

#: (model, batch, remat mode)
CONFIGS = [("volo_d4", 32, "full"), ("volo_d5", 8, "full")]
EMA_DECAYS = (0.998,)


def main(argv: Optional[List[str]] = None) -> Dict:
    from autoprog_tpu_torch import bench
    from autoprog_tpu_torch.platform import default_device
    from autoprog_tpu_torch.ops import launch_counts, launches_since
    from autoprog_tpu_torch.scripts.timing import card_name

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=0, help="0: 10 on the card, 1 on the CPU")
    args = p.parse_args(argv)
    device = default_device()
    on_card = device.type == "cuda"
    iters = args.iters or (10 if on_card else 1)
    warmup = 3 if on_card else 0
    card = card_name(device)
    start = launch_counts()
    rows = []
    for name, batch, remat in CONFIGS:
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        sb, state, data = bench.make_step(device, batch, model=name, ema_decays=EMA_DECAYS)
        state.model.remat = remat
        nparam = sum(p.numel() for p in state.model.parameters())
        t = bench.time_step(sb, state, data, 1.6e-3, r=bench.IMG_SIZE, iters=iters,
                            warmup=warmup)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None
        rows.append({"model": name, "batch": batch, "remat": remat, "params": nparam,
                     "ms": t * 1e3, "img_per_s": batch / t, "peak_gib": peak})
        print(f"{name} b={batch} remat={remat} ({nparam / 1e6:.0f}M) on {card}: "
              f"{t * 1e3:.1f} ms/step  {batch / t:.0f} img/s"
              + (f"  peak {peak:.2f} GiB" if peak is not None else ""), file=sys.stderr,
              flush=True)
        del sb, state, data
        if on_card:
            torch.cuda.empty_cache()
    launches = launches_since(start)
    result = {"metric": "volo_family_train_step_ms", "img_size": bench.IMG_SIZE, "card": card,
              "rows": rows, "launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
