"""The share of the measured window's wall time in which no device activity
runs, by chip, averaged over the chips used: 1 - (the device's busy time a
step, the union of the kernel, copy and set intervals of the profiled
slice over its steps) x (the window's steps) / (the window's wall time).
The busy time a step comes from the trace, the wall time from the
unprofiled window: the profiler slows the host, so the slice's own idle
share (the result's `busy_s` against `window_s`) reads higher than the
window's wherever a step's host time is close to its device time."""

LAYER = "device (one H100 per chip)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    steps = ctx["window"]["steps"]
    shares = [1.0 - r["busy_per_step_s"] * steps / r["wall_s"] for r in ctx["ranks"]]
    return 100.0 * sum(shares) / len(shares)
