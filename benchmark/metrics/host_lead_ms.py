"""How far the card's queue runs ahead of the host, at its nearest in a
step: at each leaf span's open, the device time at which its open event
completed less the host time at which it was recorded (both on the host
clock, `_spans.py`); each step's least lead, and the median over the
profiled slice's steps (rank 0). A lead near zero (within a launch latency)
means the card waited for the host there. The slice runs under the profiler,
which slows the host, and starts from an idle card (a synchronise before
it), so its first steps read near zero wherever the host builds its lead
slowly; the window's leads are longer. On stderr: where the
least lead falls most often, and each segment's time forward and backward
beside K1's and K2's kernel time a step. None off the card or where the
program records no spans."""

from benchmark.metrics import _spans
from benchmark.metrics._kernels import matched_us
from benchmark.metrics.mhsa_roofline_pct import PATTERN as K1
from benchmark.metrics.outlook_roofline_pct import PATTERN as K2

LAYER = "train step (train/steps.py, train/optim.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_img_per_s"
BETTER = "higher"


def compute(ctx):
    recs = _spans.records()
    if recs:
        trace = ctx["trace"]
        _spans.report(recs, {k: matched_us(trace["kernels"], p) * 1e-3 / trace["steps"]
                             for k, p in (("K1", K1), ("K2", K2))})
    return _spans.host_lead_ms(recs)
