"""The update's device time a step: the program's `step.update` span (the
gradient fills, the all-reduce across ranks, the clip, AdamW and the EMA
sweeps), summed over the profiled slice (rank 0), over its steps
(`_spans.py`). None where the program records no spans."""

from benchmark.metrics._spans import segment_ms

LAYER = "train step (train/steps.py, train/optim.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return segment_ms("step.update")
