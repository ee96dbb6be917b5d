"""The outlookers' device time a step: the program's `model.outlookers`
span (VOLO's outlook stages and their downsample: K2 and the MLPs at the
fine token grid) and its backward `model.outlookers.bwd`, summed over the
profiled slice (rank 0), over its steps (`_spans.py`). At least K2's own
kernel time a step. None where the program records no spans or the model
has no outlookers."""

from benchmark.metrics._spans import segment_ms

LAYER = "model (models/volo.py, models/vit.py, models/layers.py, losses.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return segment_ms("model.outlookers")
