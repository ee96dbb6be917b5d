"""Where the volo_d1 eval forward's time goes, counterpart of the JAX
package's `scripts/bench_eval.py`.

    python -m autoprog_tpu_torch.scripts.bench_eval [batch]

Five forwards of `bench.py`'s model (volo_h12_l18 at 224 px, bf16, random
weights from seed 0) on one batch of N(0, 1) images, each timed with no
gradient (CUDA events around `iters` calls after a warm-up,
`scripts/timing.py`):

  eval fwd full              eval mode, the whole model;
  train fwd full             train mode (BatchNorm on the batch's
                             statistics, MixToken, the aux tokens);
  eval fwd no outlookers     eval mode, the 4 outlookers skipped by the
                             keep mask;
  eval fwd no transformers   the 14 transformer blocks skipped;
  eval fwd stem+post only    both skipped.

The table goes to stderr; the last line of stdout is one JSON object with
the rows (ms), the launches of K1 and K2 over the run and the card's name
and power limit. With AUTOPROG_TORCH_DEVICE=cpu (the tests) it runs at
batch 4 by default, one call a row; such times say nothing of the card.
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
    from autoprog_tpu_torch.registry import create_model
    from autoprog_tpu_torch.scripts.bench_parts import keep_masks
    from autoprog_tpu_torch.ops import launch_counts, launches_since
    from autoprog_tpu_torch.scripts.timing import card_name, time_call

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=None)
    opts = p.parse_args(argv)
    device = default_device()
    on_card = device.type == "cuda"
    B = opts.batch or (128 if on_card else 4)
    iters, warmup = (20, 3) if on_card else (1, 0)
    torch.manual_seed(0)
    model = create_model(bench.MODEL).make(num_classes=bench.NUM_CLASSES,
                                           img_size=bench.IMG_SIZE,
                                           dtype=torch.bfloat16).to(device)
    gen = torch.Generator().manual_seed(0)
    img = torch.randn(B, bench.IMG_SIZE, bench.IMG_SIZE, 3, generator=gen).to(
        device, torch.bfloat16)
    drop_gen = torch.Generator(device).manual_seed(1)
    mix_gen = torch.Generator("cpu").manual_seed(2)
    masks = keep_masks(model)
    cases = {
        "eval fwd full": lambda: model(img, train=False),
        "train fwd full": lambda: model(img, train=True, drop_gen=drop_gen, mix_gen=mix_gen),
        "eval fwd no outlookers": lambda: model(img, train=False,
                                                keep=masks["no outlookers"]),
        "eval fwd no transformers": lambda: model(img, train=False,
                                                  keep=masks["no transformers"]),
        "eval fwd stem+post only": lambda: model(img, train=False,
                                                 keep=masks["stem+post+heads+opt only"]),
    }
    card = card_name(device)
    print(f"B={B} iters={iters} on {card}", file=sys.stderr)
    start = launch_counts()
    rows = {}
    with torch.no_grad():
        for name, fn in cases.items():
            rows[name] = time_call(fn, iters, warmup, device)
            print(f"{name:<28s} {rows[name]:8.3f} ms  {B / rows[name] * 1e3:7.0f} img/s",
                  file=sys.stderr)
    launches = launches_since(start)
    result = {"metric": "volo_d1_eval_forward_ms", "batch": B, "img_size": bench.IMG_SIZE,
              "card": card, "rows": rows, "launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
