"""The stem's device time a step: the program's `model.stem` span (VOLO's
conv stem with its BatchNorm, the patch projection and MixToken; DeiT's
patchify conv, tokens and position embedding) and its backward
`model.stem.bwd`, summed over the profiled slice (rank 0), over its steps
(`_spans.py`). None where the program records no spans."""

from benchmark.metrics._spans import segment_ms

LAYER = "model (models/volo.py, models/vit.py, models/layers.py, losses.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return segment_ms("model.stem")
