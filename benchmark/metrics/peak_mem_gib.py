"""`torch.cuda.max_memory_allocated()` over the window, after a reset
before it, on the fullest chip."""

LAYER = "device (one H100 per chip)"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "train_img_per_s"
BETTER = "lower"


def compute(ctx):
    return ctx["window_peak_bytes"] / 2 ** 30
