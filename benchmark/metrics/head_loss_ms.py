"""The head's and the loss's device time a step: the program's `model.head`
span (VOLO's class attention, norm, heads and the aux tokens' un-mixing;
DeiT's norm and heads), its `step.loss` span and the backward of both
(`model.head.bwd`, which opens with the loss's backward), summed over the
profiled slice (rank 0), over its steps (`_spans.py`). None where the
program records no spans."""

from benchmark.metrics._spans import segment_ms

LAYER = "model (models/volo.py, models/vit.py, models/layers.py, losses.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return segment_ms("model.head", "step.loss")
