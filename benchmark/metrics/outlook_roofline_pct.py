"""K2's share of its roofline: the least time of the outlookers' attention
the slice's steps need (one forward and one backward per outlooker and
step, at the value map's shape, by the frozen `cost.k2_work` at the f32
peak and the HBM rate) over the device time of the kernels that compute it
in the profiled slice (rank 0). None where no kernel matches."""

from benchmark import cost
from benchmark.metrics._kernels import share_pct

LAYER = "ops and kernels (ops/, csrc/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "higher"
#: K2's kernels: the row kernels and the general gather / dlogits ones
PATTERN = r"\boutlook_(fwd_rows|bwd_rows|dlogits_kernel|gather_kernel)\b"


def compute(ctx):
    trace = ctx["trace"]
    least = sum(cost.least_s(*cost.k2_work(side, *shape), cost.F32_FLOPS)
                for shape in cost.outlook_shapes(ctx["config"], ctx["batch"])
                for side in ("fwd", "bwd"))
    if least == 0:
        return None
    return share_pct(least, trace["kernels"], PATTERN, trace["steps"])
