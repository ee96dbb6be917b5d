"""K1's share of its roofline: the least time of the self-attention
products the slice's steps need (one forward and one backward per
self-attention block and step, at the cell's (B, n, heads, head_dim), by
the frozen `cost.k1_work` at the bf16 peak and the HBM rate) over the
device time of the kernels that compute them in the profiled slice
(rank 0). None where no kernel matches."""

from benchmark import cost
from benchmark.metrics._kernels import share_pct

LAYER = "ops and kernels (ops/, csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "higher"
#: K1's kernels: mhsa_fwd_res / mhsa_bwd_res and the streaming and f32 ones
PATTERN = r"\bmhsa_(fwd|bwd)_"


def compute(ctx):
    trace = ctx["trace"]
    least = sum(cost.least_s(*cost.k1_work(side, *shape), cost.BF16_FLOPS)
                for shape in cost.mhsa_shapes(ctx["config"], ctx["batch"])
                for side in ("fwd", "bwd"))
    return share_pct(least, trace["kernels"], PATTERN, trace["steps"])
