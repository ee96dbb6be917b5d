"""The transformer blocks' device time a step: the program's
`model.transformers` span (VOLO's position embedding and transformer
stages; DeiT's blocks) and its backward `model.transformers.bwd`, summed over
the profiled slice (rank 0), over its steps (`_spans.py`). At least K1's own
kernel time a step. None where the program records no spans."""

from benchmark.metrics._spans import segment_ms

LAYER = "model (models/volo.py, models/vit.py, models/layers.py, losses.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return segment_ms("model.transformers")
