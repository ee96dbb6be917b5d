"""BatchNorm stat utilities for the VOLO conv stem, counterpart of
`autoprog_tpu/train/bn.py`.

`recalibrate_bn` resets the running stats and re-estimates them from
`max_steps` train-mode forwards (`--recal-bn-steps`), for use after growth
when carrying the stats over is not wanted. Under a process group every rank
runs it on its shard, and the BatchNorm forward takes the global batch's
statistics (`models/layers.py:BatchNorm`), so the stats agree on every rank.
"""

from __future__ import annotations

import torch

from autoprog_tpu_torch.ops.interpolate import resize_bilinear


def reset_batch_stats(model: torch.nn.Module) -> None:
    """Fresh BatchNorm stats in place (mean 0, var 1)."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.fill_(1.0)
            else:
                buf.zero_()


@torch.no_grad()
def recalibrate_bn(ctx, loader, *, r: int, keep=None, max_steps: int = 100) -> None:
    """Re-estimate the stem's BatchNorm running stats of ctx.state's model."""
    model = ctx.state.model
    if not any(True for _ in model.buffers()):
        return
    reset_batch_stats(model)
    drop_gen = torch.Generator(ctx.device).manual_seed(ctx.args.seed + 909)
    mix_gen = torch.Generator("cpu").manual_seed(ctx.args.seed + 910)
    it = iter(loader)
    for _ in range(max_steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        images = torch.from_numpy(batch["image"]).to(ctx.device)
        model(resize_bilinear(images, r), train=True, keep=keep, drop_gen=drop_gen,
              mix_gen=mix_gen)
    # an abandoned mid-epoch iterator leaves the worker pool grinding the
    # rest of the epoch; the next full iteration starts it again
    close = getattr(loader, "close", None)
    if close is not None:
        close()
