"""The 95th percentile of all the window's step intervals: the device time
between CUDA events recorded on the stream after consecutive steps, read
after the window; across chips, each step's slowest rank. A stalled host
shows here first: the card waits for the launches of the steps it
delays."""

from benchmark import window

LAYER = "train step (train/steps.py, train/optim.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return window.step_p95(ctx["window"]["interval_sets"])
